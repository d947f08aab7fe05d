"""The port's sorted-stream engine ("stream") against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port. Integer outputs (keys, run starts and counts, liquid cells) are
held equal; float tolerances are stated per test. The substep tests hand
both packages one state (tests/test_torch_step.py) and compare the
particles element by element: both leave a substep in pass A's stream
order. On the CPU both packages add each cell's sums in stream order; on
the card the port's index_add_ adds with atomics, so there its sums are not
bit-repeatable (the tests here do not ask for that).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.ops import stream as jstream
from flipviscosity3d_tpu.ops import stream_transfers as jst
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.state import state_from_numpy
from flipviscosity3d_torch.ops import stream as tstream
from flipviscosity3d_torch.ops import stream_transfers as tst
from test_torch_step import (  # noqa: F401  (scene is a fixture)
    DT,
    _advance_both,
    _assert_frames_match,
    _assert_substep_matches,
    _jax_substep,
    _moving,
    _port_cfg,
    scene,
)

DX = 1.0 / 12
SHAPE = (12, 12, 12)
N_CELLS = 12 ** 3
FACES = ((13, 12, 12), (12, 13, 12), (12, 12, 13))
RADIUS = DX * 1.01 * np.sqrt(3) / 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _particles(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(DX, 1.0 - DX, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return pos, vel


def _payload_np(pos, vel):
    return tuple(pos[:, a] for a in range(3)) + tuple(vel[:, a]
                                                      for a in range(3))


def _streams(pos, vel, dead=0):
    """Both packages' stream of the particles, the last `dead` of them
    keyed n_cells (dead / padding) -> (JAX's, the port's)."""
    jkey = np.asarray(jstream.cell_of_position(jnp.asarray(pos), DX, SHAPE))
    if dead:
        jkey = jkey.copy()
        jkey[-dead:] = N_CELLS
    payload = _payload_np(pos, vel)
    js = jax.jit(functools.partial(jstream.stream_sort_keys,
                                   grid_shape=SHAPE))(
        jnp.asarray(jkey), tuple(jnp.asarray(p) for p in payload))
    ts = tstream.stream_sort_keys(torch.from_numpy(jkey.astype(np.int64)),
                                  tuple(torch.from_numpy(p) for p in payload),
                                  SHAPE)
    return js, ts


def _check_stream_sort_and_cell_runs(dead):
    """Sorted keys and payload, run flags, starts and counts equal to JAX's;
    with dead keys (== n_cells) those sort to the end, set starts[n_cells]
    to the first of them (as the JAX scatter does) and count in no cell."""
    pos, vel = _particles()
    js, ts = _streams(pos, vel, dead)
    for name in ("key", "new_run", "starts", "counts"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    for j, t in zip(js.sorted, ts.sorted):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int(ts.counts.sum()) == pos.shape[0] - dead
    assert int(ts.starts[-1]) == pos.shape[0] - dead
    key_s = np.sort(np.asarray(js.key))
    _, starts, counts = tstream.cell_runs(torch.from_numpy(
        key_s.astype(np.int64)), N_CELLS)
    np.testing.assert_array_equal(
        starts.numpy(), np.searchsorted(key_s, np.arange(N_CELLS + 1)))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(
        key_s, minlength=N_CELLS + 1)[:N_CELLS])


def _check_segment_reduce():
    """Per-cell sums to rtol 1e-6 and mins equal, empty cells 0 / the min
    default; the dead particles' rows (key == n_cells) dropped."""
    pos, vel = _particles()
    js, ts = _streams(pos, vel, dead=50)
    rng = np.random.default_rng(4)
    sums = [rng.normal(size=pos.shape[0]).astype(np.float32)
            for _ in range(5)]
    mins = [rng.normal(size=pos.shape[0]).astype(np.float32)
            for _ in range(3)]
    jsum, jmin = jstream.segment_reduce(
        js, [jnp.asarray(s) for s in sums], [jnp.asarray(m) for m in mins],
        0.25)
    tsum, tmin = tstream.segment_reduce(
        ts, [torch.from_numpy(s) for s in sums],
        [torch.from_numpy(m) for m in mins], 0.25)
    for j, t in zip(jsum, tsum):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
    for j, t in zip(jmin, tmin):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    empty = ts.counts.numpy() == 0
    assert empty.any() and (tmin[0].numpy()[empty] == 0.25).all()


def _check_p2g_sdf_stream():
    """The stream's pass-A transfer: phi to 1e-6 with the same cells below
    zero, the solid extrapolation at the same cells; the sums to rtol 1e-5
    and atol 1e-6 of their largest magnitude (XLA's CPU code may contract
    the weight polynomial into fused multiply-adds, and the weight *
    velocity sums cancel)."""
    pos, vel = _particles()
    js, ts = _streams(pos, vel)
    solid = np.random.default_rng(2).uniform(-0.2, 1.0, SHAPE).astype(
        np.float32)
    jphi, jsums = jax.jit(jst.p2g_sdf_stream, static_argnames=(
        "grid_shape", "face_shapes"))(js, SHAPE, DX, RADIUS,
                                      jnp.asarray(solid), FACES)
    tphi, tsums = tst.p2g_sdf_stream(ts, SHAPE, DX, RADIUS,
                                     torch.from_numpy(solid), FACES)
    jphi = np.asarray(jphi)
    np.testing.assert_allclose(tphi.numpy(), jphi, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tphi.numpy() < 0, jphi < 0)
    assert (jphi == np.float32(-0.5 * DX)).any()
    for (jv, jw), (tv, tw) in zip(jsums, tsums):
        for j, t in ((jv, tv), (jw, tw)):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                       atol=1e-6 * np.abs(j).max())


def _check_sample_mac_at():
    """Two grids per component at the particles, and one grid at midpoints
    a fifth of which lie outside the domain (masked by `valid`): to 1e-6 of
    the grids' scale (5)."""
    pos, vel = _particles()
    rng = np.random.default_rng(3)
    grids = [[rng.normal(size=f).astype(np.float32) for f in FACES]
             for _ in range(2)]
    mid = pos + rng.normal(scale=0.1, size=pos.shape).astype(np.float32)
    for p, n_grids in ((pos, 2), (mid, 1)):
        keys = np.asarray(jstream.cell_of_position(jnp.asarray(p), DX,
                                                   SHAPE))
        valid = ((p >= 0) & (p < 1.0)).all(axis=1)
        per_comp = [[grids[g][c] for g in range(n_grids)] for c in range(3)]
        want = jst.sample_mac_at(
            *(jnp.asarray(p[:, a]) for a in range(3)), jnp.asarray(keys),
            *([jnp.asarray(g) for g in comp] for comp in per_comp), DX,
            SHAPE, valid=jnp.asarray(valid))
        got = tst.sample_mac_at(
            *(torch.from_numpy(p[:, a].copy()) for a in range(3)),
            torch.from_numpy(keys.astype(np.int64)),
            *([torch.from_numpy(g) for g in comp] for comp in per_comp), DX,
            SHAPE, valid=torch.from_numpy(valid))
        for jc, tc in zip(want, got):
            for j, t in zip(jc, tc):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                           atol=5e-6)
        assert (~valid).any() == (n_grids == 1)


def test_stream_ops_match_jax():
    """stream_sort_keys and cell_runs without and with dead keys,
    segment_reduce, p2g_sdf_stream and sample_mac_at."""
    _check_stream_sort_and_cell_runs(0)
    _check_stream_sort_and_cell_runs(37)
    _check_segment_reduce()
    _check_p2g_sdf_stream()
    _check_sample_mac_at()


JAX_STREAM = JaxConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                       bucket_capacity=16, particle_engine="stream")


def test_stream_substep_and_three_frames_match_jax(scene):
    """One substep from a moving state element by element
    (_assert_substep_matches, positions to 1e-6), then three frames of
    advance from rest (_assert_frames_match: substeps, iterations and no
    overflow equal, rtol 2e-3 / atol 2e-4), liquid cells equal frame by
    frame."""
    base, arrays = scene
    cfg = _port_cfg(base, JAX_STREAM)
    assert cfg.particle_engine == "stream"
    moving = _moving(arrays)
    jnew, jd = _jax_substep(moving, 0.01, JAX_STREAM)
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), DT, cfg)
    assert int(td["bucket_overflow"]) == 0
    _assert_substep_matches(tnew, td, jnew, jd)
    ts, tds, js, jds = _advance_both(arrays, cfg, JAX_STREAM, 0.01, 3)
    _assert_frames_match(ts, tds, js, jds)
    assert [td.liquid_cells for td in tds] == [int(jd.liquid_cells)
                                               for jd in jds]
    assert all(td.bucket_overflow == 0 and td.plan_demand == 0 for td in tds)


def test_segment_sums_add_each_run_in_stream_order():
    """segment_reduce's sums equal, bit for bit, float32 sums that add each
    cell's run in stream order (np.add.at adds in index order), with the
    dead rows (key == n_cells) in no cell; two calls give the same bits."""
    pos, vel = _particles(n=20000, seed=5)
    _, ts = _streams(pos, vel, dead=77)
    rng = np.random.default_rng(6)
    sums = [rng.normal(size=pos.shape[0]).astype(np.float32)
            for _ in range(4)]
    got, _ = tstream.segment_reduce(ts, [torch.from_numpy(s) for s in sums],
                                    [], 0.25)
    again, _ = tstream.segment_reduce(
        ts, [torch.from_numpy(s) for s in sums], [], 0.25)
    key = ts.key.numpy()
    live = key < N_CELLS
    for s, g, a in zip(sums, got, again):
        want = np.zeros(N_CELLS, np.float32)
        np.add.at(want, key[live], s[live])
        np.testing.assert_array_equal(g.numpy(), want)
        assert torch.equal(g, a)
