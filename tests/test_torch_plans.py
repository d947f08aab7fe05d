"""The port's visit-plan coverage, the stale scatter (K5) and the node-SDF
corner gather (K6) against the JAX package, on the CPU.

Keys come from particles in a stale order: sorted by home key, then moved
by random steps of up to 1.5 cells, as the stale pass A finds them one
substep after a re-sort. JAX's Pallas kernels run in interpret mode, where
each one-hot contraction is one exact f32 dot (pallas_particles.py:111-115),
so slot tables, counts and corner rows must match exactly and the sums to
summation order. Coverage masks are integers and must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.ops import pallas_particles as jpp
from flipviscosity3d_tpu.ops import stream_transfers as jst
from flipviscosity3d_torch.ops import pallas_particles as tpp

SHAPE = (16, 16, 16)
DX = 1.0 / 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _stale_particles(n, shape=SHAPE, seed=3, step=1.5):
    """Clustered positions sorted by home key, then displaced by uniform
    steps of up to `step` cells per axis (kept inside the domain), and
    velocities. Returns numpy (pos, vel) f32."""
    rng = np.random.default_rng(seed)
    ext = np.array(shape, np.float64) * DX
    centers = rng.random((max(n // 25, 1), 3)) * 0.8 + 0.1
    pos = centers[rng.integers(0, len(centers), n)] + rng.normal(
        scale=0.01, size=(n, 3))
    pos = np.clip(pos, 0.01, 0.99) * ext
    key = np.asarray(jpp.key_of_position(
        jnp.asarray(pos.astype(np.float32)), DX, shape))
    pos = pos[np.argsort(key, kind="stable")]
    pos = pos + rng.uniform(-step, step, size=pos.shape) * DX
    pos = np.clip(pos, 0.001, ext - 0.001).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return pos, vel


def _keys(pos, shape=SHAPE):
    jkey = jpp.key_of_position(jnp.asarray(pos), DX, shape)
    tkey = tpp.key_of_position(torch.from_numpy(pos), DX, shape)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    return jkey, tkey


def _jax_incidences(splan, total):
    """The (tile, chunk) pairs of a JAX ScatterPlan's first `total` visits
    (the real incidences, tile-major; zeroing and pad visits follow)."""
    tabs = np.asarray(splan.tabs)
    nv = tabs.shape[0] // 2
    return tabs[:nv][:total] & jpp.TV_MASK, tabs[nv:][:total]


@pytest.mark.parametrize("budget", [27, 8, 2])
def test_plan_coverage_and_scatter_csr_match_jax(budget):
    """plan_midpoint_visits' and plan_pass_a's coverage bit for bit, and the
    scatter CSR equal to the JAX scatter plan's incidence list."""
    pos, _ = _stale_particles(4000)
    jkey, tkey = _keys(pos)
    n = pos.shape[0]
    jm = jpp.plan_midpoint_visits(jkey, n, SHAPE, budget, 3.0)
    tm = tpp.plan_midpoint_visits(tkey, budget, 3.0)
    np.testing.assert_array_equal(tm.covered.numpy(), np.asarray(jm.covered))
    jg, js = jpp.plan_pass_a(jkey, n, SHAPE, budget, 3.0)
    tplan = tpp.plan_pass_a(tkey, SHAPE, budget, 3.0)
    np.testing.assert_array_equal(tplan.covered.numpy(),
                                  np.asarray(jg.covered))
    np.testing.assert_array_equal(np.asarray(js.covered),
                                  np.asarray(jg.covered))
    if budget == 2:
        assert 0 < int(tm.covered.sum()) < n
    # the visits asked: each chunk's distinct tiles, up to the budget
    tiles = tkey.numpy() // tpp.W
    asked = sum(min(len(np.unique(tiles[c:c + tpp.C])), budget)
                for c in range(0, n, tpp.C))
    assert int(tm.visits) == int(tplan.visits) == asked

    ptr = tplan.tile_ptr.numpy()
    chunks = tplan.tile_chunks.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(chunks)
    tiles = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    jt, jc = _jax_incidences(js, len(chunks))
    np.testing.assert_array_equal(tiles, jt)
    np.testing.assert_array_equal(chunks, jc)


def test_plan_capacity_cut_matches_jax_at_600k_keys():
    """At 600,000 keys the plan holds factor * n_chunks visits (budget *
    n_chunks > 8192), so the `placed` cut decides coverage: factor 1.5
    leaves particles uncovered that the exhaustive budget covers. Keys only,
    no kernel."""
    shape = (64, 64, 64)
    n = 600_000
    pos, _ = _stale_particles(n, shape=shape, seed=5, step=3.0)
    jkey, tkey = _keys(pos, shape)
    assert tpp.midpoint_plan_size(n, 1.5, 8) == int(1.5 * ((n + 511) // 512))
    jm = jpp.plan_midpoint_visits(jkey, n, shape, 8, 1.5)
    tm = tpp.plan_midpoint_visits(tkey, 8, 1.5)
    np.testing.assert_array_equal(tm.covered.numpy(), np.asarray(jm.covered))
    assert int(tm.visits) > tpp.midpoint_plan_size(n, 1.5, 8)
    jg, _ = jpp.plan_pass_a(jkey, n, shape, 8, 1.5)
    tplan = tpp.plan_pass_a(tkey, shape, 8, 1.5)
    np.testing.assert_array_equal(tplan.covered.numpy(),
                                  np.asarray(jg.covered))
    wide = tpp.plan_midpoint_visits(tkey, 8, 27.0)
    assert int(tm.covered.sum()) < int(wide.covered.sum())


def test_stale_scatter_ref_matches_jax_inkernel_rank():
    """K5's plain version against scatter_p2g_table(inkernel_rank=True) at
    16^3, cap 4, budget 2 (some particles uncovered): sums rtol 1e-5 /
    atol 1e-6 * max|sums|; the slot table slot for slot, the counts and the
    rank overflow exact."""
    cap, budget = 4, 2
    pos, vel = _stale_particles(3000)
    jkey, tkey = _keys(pos)
    n = pos.shape[0]
    jg, js = jpp.plan_pass_a(jkey, n, SHAPE, budget, 3.0)
    payload = jpp.stale_payload(jnp.asarray(pos), jnp.asarray(vel), jkey,
                                SHAPE)
    jsums, jtbl = jpp.scatter_p2g_table(js.tabs, js.lockeys, payload, SHAPE,
                                        DX, cap, inkernel_rank=True)
    plan = tpp.plan_pass_a(tkey, SHAPE, budget, 3.0)
    cov = plan.covered.numpy()
    assert 0 < cov.sum() < n
    tsums, ttbl, tcounts = tpp.scatter_p2g_table_stale(
        torch.from_numpy(pos), torch.from_numpy(vel), tkey, plan, SHAPE, DX,
        cap)

    jsums = np.asarray(jsums)
    np.testing.assert_allclose(tsums.numpy(), jsums, rtol=1e-5,
                               atol=1e-6 * np.abs(jsums).max())
    jt = np.asarray(jtbl).reshape(*SHAPE, -1)
    np.testing.assert_array_equal(ttbl.numpy().reshape(*SHAPE, cap * 4),
                                  jt[..., :cap * 4])
    np.testing.assert_array_equal(tcounts.numpy(),
                                  jt[..., cap * 4].astype(np.int32))
    overflow = int(tpp.table_rank_overflow(tcounts, cap))
    assert overflow == int(jpp.table_rank_overflow(jtbl, SHAPE, cap)) > 0
    assert int(tcounts.sum()) == int(cov.sum())


def test_stale_order_ranks_match_the_stale_scatter_ref():
    """The plain version of K5's order half (stale_order_ref) at 16^3,
    budget 2 (some particles uncovered): it orders exactly the covered
    particles, by key and stream position; the ranks it implies are
    stale_ranks', which scatter_p2g_table_stale_ref slots by (and which
    test_stale_scatter_ref_matches_jax_inkernel_rank holds against JAX);
    its tile offsets follow the plain version's counts."""
    pos, vel = _stale_particles(3000, seed=11)
    _, tkey = _keys(pos)
    plan = tpp.plan_pass_a(tkey, SHAPE, 2, 3.0)
    assert 0 < int(plan.covered.sum()) < tkey.shape[0]
    order, tile_off = tpp.stale_order_ref(tkey, plan, SHAPE)
    assert torch.equal(torch.sort(order).values,
                       torch.nonzero(plan.covered)[:, 0])
    key_o = tkey[order]
    assert bool((key_o[1:] >= key_o[:-1]).all())
    same = key_o[1:] == key_o[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    rank = torch.full(tkey.shape, -1, dtype=torch.int32)
    rank[order] = tpp.run_ranks(key_o, torch.int32)
    assert torch.equal(rank[plan.covered],
                       tpp.stale_ranks(tkey, plan.covered))
    _, _, counts = tpp.scatter_p2g_table_stale_ref(
        torch.from_numpy(pos), torch.from_numpy(vel), tkey, plan.covered,
        SHAPE, DX, 4)
    per_tile = tpp.to_tile_major(counts[..., None].long()).sum(dim=(1, 2))
    assert torch.equal(tile_off[1:] - tile_off[:-1], per_tile)


def test_gather_rows8_ref_matches_jax_kernel():
    """K6's plain version against gather_rows8 over
    pack_cols8(stack_tile_major(node_corner_columns(phi))) through a
    midpoint plan of budget 2: exact, zero rows for uncovered particles."""
    pos, _ = _stale_particles(3000, seed=8)
    jkey, tkey = _keys(pos)
    n = pos.shape[0]
    phi = np.random.default_rng(9).normal(
        scale=0.05, size=(17, 17, 17)).astype(np.float32)
    plan = jpp.plan_midpoint_visits(jkey, n, SHAPE, 2, 3.0)
    cols = jst.node_corner_columns(jnp.asarray(phi), SHAPE)
    packed = jpp.pack_cols8(jpp.stack_tile_major(
        [c.reshape(SHAPE) for c in cols], SHAPE))
    jrows = np.asarray(jpp.gather_rows8(plan.tabs, plan.lockeys, packed, n))
    cov = tpp.plan_midpoint_visits(tkey, 2, 3.0).covered
    assert 0 < int(cov.sum()) < n
    trows = tpp.gather_rows8(tkey, cov, torch.from_numpy(phi), SHAPE)
    assert trows.shape == (8, n)
    np.testing.assert_array_equal(trows.numpy(), jrows)
    assert (trows[:, ~cov] == 0).all() and (trows[:, cov] != 0).any()
