"""The port's tile-major column tools against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port, at 16^3 and on the non-cubic grids (16, 8, 24),
(24, 16, 8) and (8, 16, 32).
JAX's Pallas kernels (detile, gather_rows, gather_mac) run in interpret
mode; on CPU tensors the port's wrappers take their plain versions. Layout
conversions and gathers are copies and must agree exactly; the trilinear
combine is held to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.ops import pallas_particles as jpp
from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.ops import pallas_particles as tpp

SHAPES = [(16, 16, 16), (16, 8, 24), (24, 16, 8), (8, 16, 32)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(x):
    """A JAX or torch array, bf16 included, as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _faces(shape):
    i, j, k = shape
    return ((i + 1, j, k), (i, j + 1, k), (i, j, k + 1))


def _grids(shape, n_grids, seed):
    """n_grids MAC grids per component -> (grids_u, grids_v, grids_w)."""
    rng = np.random.default_rng(seed)
    return tuple([rng.normal(size=fs).astype(np.float32)
                  for _ in range(n_grids)] for fs in _faces(shape))


def _positions(shape, n, seed, spread=0.9):
    rng = np.random.default_rng(seed)
    ext = np.array(shape, np.float32) / 16
    pos = (0.5 + (rng.random((n, 3)) - 0.5) * spread) * ext
    return pos.astype(np.float32)


def _sorted_stream(shape, n, seed):
    """A JAX TiledStream of seeded positions and the same stream's keys and
    positions as torch tensors."""
    pos = _positions(shape, n, seed)
    js = jpp.tiled_sort(jnp.asarray(pos), jnp.zeros((n, 3), jnp.float32),
                        1.0 / 16, shape)
    key = torch.from_numpy(np.array(js.key))
    ps = [torch.from_numpy(np.array(js.sorted[a])) for a in range(3)]
    return js, key, ps


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("f", [3, 108])
def test_tile_major_layouts_and_detile_match_jax_exactly(shape, f):
    x = np.random.default_rng(1).normal(size=(*shape, f)).astype(np.float32)
    jy = jpp.to_tile_major(jnp.asarray(x))
    ty = tpp.to_tile_major(torch.from_numpy(x))
    assert ty.is_contiguous()
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(
        tpp.from_tile_major(ty, shape).numpy(), x)
    np.testing.assert_array_equal(
        tpp.detile(ty, shape).numpy(), np.asarray(jpp.detile(jy, shape)))
    cols = [x[..., lane] for lane in range(f)]
    np.testing.assert_array_equal(
        tpp.stack_tile_major([torch.from_numpy(c.copy()) for c in cols],
                             shape).numpy(),
        np.asarray(jpp.stack_tile_major([jnp.asarray(c) for c in cols],
                                        shape)))


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("f", [1, 2, 3, 4, 6, 54, 108])
def test_detile_places_each_cell_by_its_key(shape, f):
    """detile against the definition, in numpy: cell (i, j, k) of the
    output is row tile_major_key(i, j, k) of the tile image, for row widths
    that are and are not multiples of 2 and 4 (the kernel's three copy
    widths). Exact."""
    rng = np.random.default_rng(12)
    n_cells = int(np.prod(shape))
    y = rng.normal(size=(n_cells // 512, 512, f)).astype(np.float32)
    i, j, k = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    key = tpp.tile_major_key(*(torch.from_numpy(a) for a in (i, j, k)),
                             shape).numpy()
    got = tpp.detile(torch.from_numpy(y), shape)
    assert tuple(got.shape) == (*shape, f) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), y.reshape(-1, f)[key])
    assert torch.equal(tpp.to_tile_major(got), torch.from_numpy(y))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("f", [1, 3, 8, 53, 54, 55, 108, 112])
def test_gather_rows_reads_the_first_f_lanes_of_each_key(f, dtype):
    """gather_rows against the definition, in numpy: rows[p, l] =
    image[key_p // 512, l, key_p % 512] for l < f_logical, whatever the
    image's own lane count (112 here), keys unsorted and repeated,
    uncovered rows zero, a bf16 image widened exactly."""
    rng = np.random.default_rng(13)
    n, n_tiles = 1500, 4
    key = rng.integers(0, n_tiles * 512, n).astype(np.int32)
    covered = rng.random(n) < 0.7
    image = torch.from_numpy(rng.normal(size=(n_tiles, 112, 512)).astype(
        np.float32)).to(DTYPES[dtype][1])
    want = _np(image)[key // 512, :f, key % 512] * covered[:, None]
    got = tpp.gather_rows(torch.from_numpy(key), torch.from_numpy(covered),
                          image, f)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, f)
    np.testing.assert_array_equal(got.numpy(), want)
    every = tpp.gather_rows(torch.from_numpy(key), None, image, f)
    np.testing.assert_array_equal(every.numpy(),
                                  _np(image)[key // 512, :f, key % 512])
    with pytest.raises(ValueError, match="f_logical"):
        tpp.gather_rows(torch.from_numpy(key), None, image, 113)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("f", [54, 108])
def test_stack_tile_major_fw_matches_jax_exactly(shape, dtype, f):
    """Exact in both dtypes (the bf16 rounding is the same round to nearest
    even), pad lanes zero, and one slab per tile row (2 or 3 slabs; 1 on
    the grid of one tile row) equal to 1 slab; a slab count that does not
    divide the tile rows raises."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(2).normal(size=(f, *shape)).astype(np.float32)
    want = jpp.stack_tile_major_fw([jnp.asarray(c) for c in x], shape,
                                   i_slabs=1, dtype=jdt)
    cols = [torch.from_numpy(c) for c in x]
    got = tpp.stack_tile_major_fw(cols, shape, i_slabs=1, dtype=tdt)
    f_pad = -(-f // 8) * 8
    assert got.dtype == tdt and got.is_contiguous()
    assert tuple(got.shape) == (np.prod(shape) // 512, f_pad, 512)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert f_pad > f and bool((got[:, f:] == 0).all())
    rows = shape[0] // 8
    assert torch.equal(
        tpp.stack_tile_major_fw(cols, shape, i_slabs=rows, dtype=tdt), got)
    assert torch.equal(tpp.stack_tile_major_fw(cols, shape, dtype=tdt), got)
    with pytest.raises(ValueError, match="slabs"):
        tpp.stack_tile_major_fw(cols, shape, i_slabs=rows + 1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_grids,dtype", [(1, "f32"), (2, "f32"),
                                            (2, "bf16")])
def test_build_mac_columns_matches_jax_exactly(shape, n_grids, dtype):
    jdt, tdt = DTYPES[dtype]
    grids = _grids(shape, n_grids, 3)
    want = jpp.build_mac_columns(
        *([jnp.asarray(g) for g in comp] for comp in grids), shape, dtype=jdt)
    got = tpp.build_mac_columns(
        *([torch.from_numpy(g) for g in comp] for comp in grids), shape,
        dtype=tdt)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("f", [54, 108])
def test_gather_rows_matches_jax_kernel_exactly(shape, f):
    """A sorted stream through JAX's stream plan (every particle covered),
    against the port's gather on the same keys and image."""
    n = 3000
    js, key, _ = _sorted_stream(shape, n, 4)
    x = np.random.default_rng(5).normal(size=(f, *shape)).astype(np.float32)
    jcols = jpp.stack_tile_major_fw([jnp.asarray(c) for c in x], shape)
    tcols = tpp.stack_tile_major_fw([torch.from_numpy(c) for c in x], shape)
    want = np.asarray(jpp.gather_rows(js.plan.tabs, js.plan.lockeys, jcols,
                                      n, f_logical=f))
    got = tpp.gather_rows(key, None, tcols, f)
    assert tuple(got.shape) == (n, f)
    np.testing.assert_array_equal(got.numpy(), want)
    bf = tpp.gather_rows(key, None, tcols.to(torch.bfloat16), f)
    assert bf.dtype == torch.float32
    assert torch.equal(bf, got.to(torch.bfloat16).float())


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_rows_zeroes_uncovered_rows_like_jax_midpoint_plan(shape):
    """Unsorted keys under a midpoint plan of budget 2: the plan leaves
    particles uncovered, whose rows are zero in both packages."""
    n = 3000
    pos = _positions(shape, n, 6)
    key = jpp.key_of_position(jnp.asarray(pos), 1.0 / 16, shape)
    jplan = jpp.plan_midpoint_visits(key, n, shape, 2, 3.0)
    x = np.random.default_rng(7).normal(size=(54, *shape)).astype(np.float32)
    jcols = jpp.stack_tile_major_fw([jnp.asarray(c) for c in x], shape)
    want = np.asarray(jpp.gather_rows(jplan.tabs, jplan.lockeys, jcols, n,
                                      f_logical=54))
    tkey = torch.from_numpy(np.array(key))
    tplan = tpp.plan_midpoint_visits(tkey, 2, 3.0)
    np.testing.assert_array_equal(tplan.covered.numpy(),
                                  np.asarray(jplan.covered))
    assert 0 < int(tplan.covered.sum()) < n
    got = tpp.gather_rows(
        tkey, tplan.covered,
        tpp.stack_tile_major_fw([torch.from_numpy(c) for c in x], shape), 54)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got[~tplan.covered] == 0).all())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_grids", [1, 2])
def test_combine_mac_samples_matches_jax(shape, n_grids):
    """The same rows, positions and keys through both combines, with and
    without a validity mask: rtol 1e-6 / atol 1e-6 (one expression, f32
    rounding of the products apart)."""
    n = 2000
    _, key, ps = _sorted_stream(shape, n, 8)
    rng = np.random.default_rng(9)
    rows = rng.normal(size=(n, 54 * n_grids)).astype(np.float32)
    valid = rng.random(n) < 0.8
    for mask in (None, valid):
        want = jpp.combine_mac_samples(
            jnp.asarray(rows), *(jnp.asarray(p.numpy()) for p in ps),
            jnp.asarray(key.numpy()), 1.0 / 16, shape, n_grids,
            valid=None if mask is None else jnp.asarray(mask))
        got = tpp.combine_mac_samples(
            torch.from_numpy(rows), *ps, key, 1.0 / 16, shape, n_grids,
            valid=None if mask is None else torch.from_numpy(mask))
        for comp in range(3):
            assert len(got[comp]) == n_grids
            for g in range(n_grids):
                np.testing.assert_allclose(
                    got[comp][g].numpy(), np.asarray(want[comp][g]),
                    rtol=1e-6, atol=1e-6)
    assert bool((got[0][0][~torch.from_numpy(valid)] == 0).all())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_grids,dtype,split", [
    (2, "f32", False), (2, "bf16", False), (1, "f32", False),
    (2, "f32", True)])
def test_unfused_route_matches_gather_mac_ref(shape, n_grids, dtype, split):
    """build_mac_columns -> gather_rows -> combine_mac_samples against the
    port's gather_mac_ref on the same particles (under bf16 on grids
    rounded to bf16), every sample row: rtol 1e-5 / atol 1e-6, what the JAX
    package holds its fused kernel to against this route. Midpoint-like
    positions, some outside the domain."""
    n = 2500
    pos = _positions(shape, n, 10, spread=1.1)
    assert ((pos < 0).any() or (pos >= np.array(shape) / 16).any())
    tpos = torch.from_numpy(pos)
    key = tpp.key_of_position(tpos, 1.0 / 16, shape)
    ps = [tpos[:, a].contiguous() for a in range(3)]
    grids = [[torch.from_numpy(g) for g in comp]
             for comp in _grids(shape, n_grids, 11)]
    got = smoke.unfused_gather_mac(*ps, key, *grids, 1.0 / 16, shape,
                                   dtype=DTYPES[dtype][1], split=split)
    if dtype == "bf16":
        grids = [[g.to(torch.bfloat16).float() for g in comp]
                 for comp in grids]
    want = tpp.gather_mac_ref(*ps, key, *grids, 1.0 / 16, shape)
    assert tuple(got.shape) == (3 * n_grids, n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
