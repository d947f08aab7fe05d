"""The port's slab collectives, halo primitives and slab V-cycle, on the CPU.

The halo primitives run on a LocalGroup of 4 and 8 rank-threads and are
held against the JAX package's under shard_map on the forced host devices
(tests/conftest.py), after the templates of tests/test_halo.py: exchange,
min and the slab cut exactly (torch.equal), sums within rtol 1e-6. The
slab V-cycle is held against the port's single-device v_cycle on the same
right-hand side (rtol 1e-5): it applies the same operator.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.parallel import halo, slab_mg
from flipviscosity3d_torch.parallel.collectives import LocalGroup, ring
from flipviscosity3d_torch.solvers import multigrid as mg
from flipviscosity3d_tpu.parallel import halo as jhalo

I, J, K = 32, 8, 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _global(seed):
    return np.random.default_rng(seed).normal(size=(I, J, K)).astype(
        np.float32)


def _jax_slabs(fn, n, g):
    """fn(replicated global) -> local slab, per shard under shard_map over
    the first n host devices -> (n, ...) numpy."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    out = shard_map(lambda a: fn(a)[None], mesh=mesh, in_specs=(P(),),
                    out_specs=P("x"))(jnp.asarray(g))
    return np.asarray(out)


def _port_slabs(fn, n, g):
    """fn(rank handle, global tensor) on a LocalGroup of n -> (n, ...)."""
    t = torch.from_numpy(g)
    return torch.stack(LocalGroup(n, "cpu", timeout=60).run(
        lambda r: fn(r, t))).numpy()


@pytest.mark.parametrize("n, h", [(4, 2), (8, 2), (8, 3)])
def test_slab_and_exchange_equal_jax(n, h):
    """slab (fill 7) equal to JAX's; its halos zeroed and refilled by
    halo_exchange equal to JAX's exchange of the same, and to the slab."""
    g = _global(0)

    def jax_fn(a):
        s = jhalo.slab(a, "x", n, h, fill=7.0)
        z = jnp.concatenate([jnp.zeros_like(s[:h]), s[h:-h],
                             jnp.zeros_like(s[:h])])
        return jnp.stack([s, jhalo.halo_exchange(z, "x", h, fill=7.0)])

    def port_fn(r, a):
        s = halo.slab(a, r, n, h, fill=7.0)
        z = torch.cat([torch.zeros_like(s[:h]), s[h:-h],
                       torch.zeros_like(s[:h])])
        return torch.stack([s, halo.halo_exchange(z, r, h, fill=7.0)])

    want = _jax_slabs(jax_fn, n, g)
    got = _port_slabs(port_fn, n, g)
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, 0], got[:, 1])
    owned = np.concatenate([halo.unslab(torch.from_numpy(s), h).numpy()
                            for s in got[:, 0]])
    assert np.array_equal(owned, g)


def _accumulate(s, h, reach, combine, init):
    """Each owned row of slab s adds (combine) into rows i - o .. i + o for
    o <= reach of an accumulator filled with init (a scatter with halo)."""
    acc = torch.full_like(s, init)
    owned = s[h:-h]
    rows = s.shape[0]
    for o in range(-reach, reach + 1):
        sl = acc[h + o:rows - h + o]
        sl.copy_(combine(sl, owned))
    return acc


def _jax_accumulate(s, h, reach, op, init):
    acc = jnp.full_like(s, init)
    owned = s[h:-h]
    rows = s.shape[0]
    for o in range(-reach, reach + 1):
        ref = acc.at[h + o:rows - h + o]
        acc = ref.add(owned) if op == "sum" else ref.min(owned)
    return acc


@pytest.mark.parametrize("n, h, reach", [(4, 1, 1), (8, 1, 1), (8, 3, 3)])
def test_halo_reduce_sum_matches_jax(n, h, reach):
    """A scatter of every owned row into its i +- reach neighbours, folded
    by halo_reduce, against JAX's; at n = 8, h = 3 the owned width 4 < 2h,
    so the two incoming windows overlap. Within rtol 1e-6; the owned rows
    also equal the global stencil's."""
    g = _global(1)

    def jax_fn(a):
        s = jhalo.slab(a, "x", n, h)
        return jhalo.halo_reduce(_jax_accumulate(s, h, reach, "sum", 0.0),
                                 "x", h, op="sum")

    def port_fn(r, a):
        s = halo.slab(a, r, n, h)
        return halo.halo_reduce(
            _accumulate(s, h, reach, torch.add, 0.0), r, h, op="sum")

    want = _jax_slabs(jax_fn, n, g)
    got = _port_slabs(port_fn, n, g)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    stencil = g.copy()
    for o in range(1, reach + 1):
        stencil[o:] += g[:-o]
        stencil[:-o] += g[o:]
    owned = got[:, h:-h].reshape(I, J, K)
    np.testing.assert_allclose(owned, stencil, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n, h, reach", [(4, 1, 1), (8, 3, 3)])
def test_halo_reduce_min_matches_jax(n, h, reach):
    """The same scatter as a min with reset 99: equal to JAX's."""
    g = _global(2)
    big = 99.0

    def jax_fn(a):
        s = jhalo.slab(a, "x", n, h, fill=big)
        return jhalo.halo_reduce(_jax_accumulate(s, h, reach, "min", big),
                                 "x", h, op="min", reset=big)

    def port_fn(r, a):
        s = halo.slab(a, r, n, h, fill=big)
        return halo.halo_reduce(
            _accumulate(s, h, reach, torch.minimum, big), r, h, op="min",
            reset=big)

    assert np.array_equal(_port_slabs(port_fn, n, g),
                          _jax_slabs(jax_fn, n, g))


@pytest.mark.parametrize("rows, h", [(12, 2), (20, 8)])
def test_owned_mask_rows_equals_jax(rows, h):
    got = halo.owned_mask_rows(rows, h).numpy()
    assert np.array_equal(got, np.asarray(jhalo.owned_mask_rows(rows, h)))


def test_reductions_give_every_rank_the_same_bits():
    """psum and pmax of values that do not add associatively: every rank
    holds the same bits, the sum taken in rank order."""
    vals = [1e8, 1.0, -1e8, 3.5e-3, 7.0, -2.5]
    n = len(vals)

    def fn(r):
        x = torch.tensor(vals[r.rank], dtype=torch.float32)
        return r.psum(x), r.pmax(x)

    out = LocalGroup(n, "cpu", timeout=60).run(fn)
    want = torch.tensor(vals, dtype=torch.float32).sum()
    for s, m in out:
        assert torch.equal(s, out[0][0]) and torch.equal(s, want)
        assert float(m) == max(vals)


def test_ppermute_and_all_gather_follow_rank_order():
    """ppermute (and ppermute_many) delivers along its pairs and zeros where
    nothing arrives; all_gather concatenates in rank order; each rank
    tallies its calls and the bytes it sent."""
    n = 5

    def fn(r):
        x = torch.full((2, 3), float(r.rank))
        right = r.ppermute(x, ring(n, +1))
        left, = r.ppermute_many([(x, ring(n, -1))])
        return right, left, r.all_gather(x, 0)

    group = LocalGroup(n, "cpu", timeout=60)
    out = group.run(fn)
    for rank, (right, left, gathered) in enumerate(out):
        assert torch.equal(right, torch.full((2, 3), float(rank - 1))
                           if rank > 0 else torch.zeros(2, 3))
        assert torch.equal(left, torch.full((2, 3), float(rank + 1))
                           if rank < n - 1 else torch.zeros(2, 3))
        assert torch.equal(gathered, torch.arange(n).float()
                           .repeat_interleave(2)[:, None].expand(10, 3))
    counts = group.counts()
    assert counts["ppermute"] == {"calls": 2, "bytes": 2 * (n - 1) * 24}
    assert counts["all_gather"] == {"calls": 1, "bytes": n * 24}


def test_a_faulting_rank_raises_its_own_error_promptly():
    """A rank that raises breaks the barrier for the others: run raises the
    rank's error, not the others' broken barrier, long before the timeout;
    the group runs again afterwards."""
    group = LocalGroup(4, "cpu", timeout=30)

    def fn(r):
        r.psum(torch.ones(()))
        if r.rank == 2:
            raise KeyError("rank 2 failed")
        return r.psum(torch.ones(()))

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="rank 2 failed"):
        group.run(fn)
    assert time.perf_counter() - t0 < 10.0
    assert [float(x) for x in group.run(lambda r: r.psum(torch.ones(())))
            ] == [4.0] * 4


def _random_operator(shape, gen, empty_last_row=False):
    """An SPD 7-point operator (diag, links) on `shape`, links zero at the
    far boundary of each axis, diag above the links' row sums; with
    `empty_last_row` the last i-row is empty (the single-device viscosity
    blocks' padding row)."""
    links = []
    for ax in range(3):
        L = torch.rand(shape, generator=gen)
        idx = [slice(None)] * len(shape)
        idx[len(shape) - 3 + ax] = -1
        L[tuple(idx)] = 0.0
        links.append(L)
    diag = 0.5 + torch.rand(shape, generator=gen)
    for ax, L in enumerate(links):
        diag = diag + L + mg._shift(L, mg._off(ax, -1))
    if empty_last_row:
        diag[..., -1, :, :] = 0.0
        for L in links:
            L[..., -1, :, :] = 0.0
        links[0][..., -2, :, :] = 0.0
    return diag, tuple(links)


@pytest.mark.parametrize("n, shape, extra", [
    (4, (32, 16, 16), 0),          # pressure-like: (I, J, K)
    (4, (3, 33, 17, 17), 1),       # viscosity-like: padded to I + 1 rows
    (2, (3, 33, 33, 33), 1),
    (4, (40, 32, 32), 0),          # odd B_l = 5: a tail of two levels
])
def test_slab_v_cycle_matches_single_device(n, shape, extra):
    """slab_v_cycle over n ranks on the owned rows of an operator equals the
    single-device v_cycle of the whole operator on the same right-hand
    side, within rtol 1e-5; with `extra` the single-device operator has
    the viscosity blocks' empty padding row, which the slabs do not hold.
    Both hierarchies have the same depth."""
    gen = torch.Generator().manual_seed(3)
    cfg = SimConfig()
    diag, links = _random_operator(shape, gen, empty_last_row=bool(extra))
    b = torch.randn(shape, generator=gen)
    if extra:
        b[..., -1, :, :] = 0.0
    hier = mg.build_hierarchy(diag, links, cfg)
    want = mg.v_cycle(hier, b, cfg.mg_pre_smooth, cfg.mg_post_smooth,
                      cfg.mg_omega, cfg.mg_coarse_scale)
    rows = (shape[-3] - extra) // n

    def own(x, r):
        return x[..., r.rank * rows:(r.rank + 1) * rows, :, :]

    def fn(r):
        sh = slab_mg.build_slab_hierarchy(
            own(diag, r), tuple(own(L, r) for L in links), cfg, r,
            extra_rows=extra)
        return sh, slab_mg.slab_v_cycle(sh, own(b, r), cfg, r)

    out = LocalGroup(n, "cpu", timeout=60).run(fn)
    got = torch.cat([x for _, x in out], dim=-3)
    depth = len(out[0][0].levels) - 1 + len(out[0][0].tail.levels)
    assert depth == len(hier.levels)
    np.testing.assert_allclose(got.numpy(), want[..., :shape[-3] - extra,
                                                 :, :].numpy(),
                               rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_slab_v_cycle_tail_runs_plain_levels():
    """The gathered tail is built with mg_backend "xla" whatever the config
    asks: f32 level operators, which mg_down / mg_up run above its coarsest
    level (on the CPU their wrappers run the plain levels). 40 rows in 4
    slabs coarsen to an odd B_l = 5 and gather a tail of two levels."""
    gen = torch.Generator().manual_seed(4)
    cfg = dataclasses.replace(SimConfig(), mg_backend="pallas")
    diag, links = _random_operator((40, 32, 32), gen)

    def fn(r):
        rows = 10
        own = lambda x: x[r.rank * rows:(r.rank + 1) * rows]  # noqa: E731
        tail = slab_mg.build_slab_hierarchy(
            own(diag), tuple(own(L) for L in links), cfg, r).tail
        return ([tuple(lv.diag.shape) for lv in tail.levels],
                [(d.dtype, *(lk.dtype for lk in ls)) for d, ls in tail.ops])

    out = LocalGroup(4, "cpu", timeout=60).run(fn)
    assert out == [([(1, 20, 16, 16), (1, 10, 8, 8)],
                    [(torch.float32,) * 4])] * 4
