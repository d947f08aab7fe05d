"""The port's particle engine against the JAX package, on the CPU.

The plain versions of the two particle CUDA kernels (scatter_p2g_table_ref,
gather_mac_ref) are held against JAX's Pallas kernels in interpret mode,
which on the CPU run one exact f32 dot per one-hot contraction
(pallas_particles.py:111-115): tolerances cover summation order only.
Keys, ranks and decodes are integers and must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.ops import buckets as jbk
from flipviscosity3d_tpu.ops import pallas_particles as jpp
from flipviscosity3d_tpu.ops import stream_transfers as jst
from flipviscosity3d_torch.ops import buckets as tbk
from flipviscosity3d_torch.ops import pallas_particles as tpp
from flipviscosity3d_torch.ops import stream_transfers as tst
from flipviscosity3d_torch.ops.particle_grid import liquid_sdf_from_particles

SHAPE = (16, 16, 16)
DX = 1.0 / 16
FACES = ((17, 16, 16), (16, 17, 16), (16, 16, 17))
RADIUS = DX * 1.01 * (3.0 ** 0.5) / 2.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _particles(n=3000, seed=11, spread=0.9):
    """Clustered positions (several per cell, so ranks reach the cap) and
    velocities; spread > 1 puts some positions outside the domain."""
    rng = np.random.default_rng(seed)
    centers = rng.random((n // 25, 3)) * 0.8 + 0.1
    pos = centers[rng.integers(0, len(centers), n)] + rng.normal(
        scale=0.006, size=(n, 3))
    pos = (0.5 + (pos - 0.5) * spread).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return pos, vel


def test_keys_decode_sort_and_ranks_match_jax_exactly():
    pos, vel = _particles(spread=1.2)
    jkey = np.asarray(jpp.key_of_position(jnp.asarray(pos), DX, SHAPE))
    tkey = tpp.key_of_position(torch.from_numpy(pos), DX, SHAPE)
    np.testing.assert_array_equal(tkey.numpy(), jkey)
    for jd, td in zip(jpp.decode_key(jnp.asarray(jkey), SHAPE),
                      tpp.decode_key(tkey, SHAPE)):
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(
        tbk.cell_of_position(torch.from_numpy(pos), DX, SHAPE).numpy(),
        np.asarray(jbk.cell_of_position(jnp.asarray(pos), DX, SHAPE)))

    js = jpp.tiled_sort(jnp.asarray(pos), jnp.asarray(vel), DX, SHAPE)
    ts = tpp.tiled_sort(torch.from_numpy(pos), torch.from_numpy(vel), DX,
                        SHAPE)
    np.testing.assert_array_equal(ts.key.numpy(), np.asarray(js.key))
    np.testing.assert_array_equal(ts.rank.numpy(), np.asarray(js.rank))
    np.testing.assert_array_equal(
        ts.pos.numpy(), np.stack([np.asarray(a) for a in js.sorted[:3]], 1))
    np.testing.assert_array_equal(
        ts.vel.numpy(), np.stack([np.asarray(a) for a in js.sorted[3:]], 1))
    assert ts.rank.max() >= 16   # the cap below really drops particles


@pytest.mark.parametrize("cap", [4, 16])
def test_scatter_ref_matches_jax_kernel(cap):
    """Sums rtol 1e-5 / atol 1e-6 * max|sums|; the slot table exact on the
    first cap*4 lanes of each cell; the overflow count equal. Also the
    downstream SDF sweep and face combine."""
    pos, vel = _particles()
    js = jpp.tiled_sort(jnp.asarray(pos), jnp.asarray(vel), DX, SHAPE)
    jsums, jtbl = jpp.scatter_p2g_table(
        js.plan.tabs, js.plan.lockeys, js.payload, SHAPE, DX, cap)
    ts = tpp.tiled_sort(torch.from_numpy(pos), torch.from_numpy(vel), DX,
                        SHAPE)
    tsums, ttbl = tpp.scatter_p2g_table(ts.pos, ts.vel, ts.key, ts.rank,
                                        SHAPE, DX, cap)
    jsums = np.asarray(jsums)
    np.testing.assert_allclose(tsums.numpy(), jsums, rtol=1e-5,
                               atol=1e-6 * np.abs(jsums).max())
    jtbl = np.asarray(jtbl).reshape(*SHAPE, -1)[..., :cap * 4]
    np.testing.assert_array_equal(ttbl.numpy().reshape(*SHAPE, cap * 4),
                                  jtbl)
    assert int((ts.rank >= cap).sum()) == int(jnp.sum(js.rank >= cap))

    center_phi = np.random.default_rng(2).normal(
        scale=0.05, size=SHAPE).astype(np.float32)
    jphi = jpp.liquid_sdf_from_fields(
        jpp.table_fields(jnp.asarray(np.asarray(jtbl).reshape(
            SHAPE[0], SHAPE[1], -1)), SHAPE, cap),
        SHAPE, DX, RADIUS, jnp.asarray(center_phi))
    tphi = liquid_sdf_from_particles(tpp.table_fields(ttbl, cap), SHAPE, DX,
                                     RADIUS, torch.from_numpy(center_phi))
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=1e-6,
                               atol=1e-7)

    jcomb = jpp.p2g_combine(jnp.asarray(jsums), SHAPE, FACES)
    tcomb = tpp.p2g_combine(tsums, SHAPE, FACES)
    for (jv, jw), (tv, tw) in zip(jcomb, tcomb):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6 * np.abs(jsums).max())
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6 * np.abs(jsums).max())


@pytest.mark.parametrize("n_grids", [1, 2])
def test_gather_ref_matches_jax_kernel(n_grids):
    """Positions partly outside the domain (the midpoint case: the home key
    is clamped, corners outside the window weigh 0): rtol 1e-5 /
    atol 1e-6."""
    pos, _ = _particles(spread=1.3)
    assert ((pos < 0) | (pos >= 1)).any()
    rng = np.random.default_rng(4)
    grids = [[rng.normal(size=fs).astype(np.float32) for fs in FACES]
             for _ in range(n_grids)]
    key = jpp.key_of_position(jnp.asarray(pos), DX, SHAPE)
    key_s, (bx, by, bz), plan = jpp.sort_by_key(
        key, tuple(jnp.asarray(pos[:, a]) for a in range(3)), SHAPE)
    pay = jpp.gather_payload(bx, by, bz, key_s, SHAPE)
    cols = jpp.build_mac_columns(
        *([jnp.asarray(g[c]) for g in grids] for c in range(3)), SHAPE)
    jout = np.asarray(jpp.gather_mac(plan.tabs, plan.lockeys, pay, cols,
                                     pos.shape[0], DX, n_grids))
    tout = tpp.gather_mac(
        *(torch.from_numpy(np.array(a)) for a in (bx, by, bz, key_s)),
        *([torch.from_numpy(g[c]) for g in grids] for c in range(3)),
        DX, SHAPE)
    assert tout.shape == (3 * n_grids, pos.shape[0])
    np.testing.assert_allclose(tout.numpy(), jout[:3 * n_grids], rtol=1e-5,
                               atol=1e-6)


def test_solid_pushback_matches_jax():
    """Positions inside the clamp box, node SDF with solid regions:
    displacements to 1e-6."""
    rng = np.random.default_rng(9)
    pos = (rng.random((2000, 3)) * 0.86 + 0.07).astype(np.float32)
    phi = rng.normal(scale=0.05, size=(17, 17, 17)).astype(np.float32)
    jkey = jbk.cell_of_position(jnp.asarray(pos), DX, SHAPE)
    jd = jst.solid_pushback_at(*(jnp.asarray(pos[:, a]) for a in range(3)),
                               jkey, jnp.asarray(phi), DX, SHAPE)
    tkey = tbk.cell_of_position(torch.from_numpy(pos), DX, SHAPE)
    td = tst.solid_pushback_at(
        *(torch.from_numpy(pos[:, a].copy()) for a in range(3)), tkey,
        torch.from_numpy(phi), DX, SHAPE)
    for j, t in zip(jd, td):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    assert any(np.abs(np.asarray(j)).max() > 0 for j in jd)
