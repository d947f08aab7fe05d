"""The large-scene switches of the port against the JAX package, on the CPU,
at 16^3: the K-folded sums of both scatters, the slabbed face combine, and
both together under the auto rule, against the JAX substep with its split
pass-A gather (which the port takes as a config field and runs fused).

The JAX package turns these on by itself at >= 2^24 cells (256^3), which no
CPU test reaches. So the JAX functions are called with their explicit
arguments (fold_sums=True, i_slabs, pallas_split_gather=True), and the
port's auto rule is patched to 16^3 in the tests only
(ops.pallas_particles.FOLD_CELLS). The JAX Pallas kernels run in interpret
mode, which on the CPU is one exact f32 dot per one-hot contraction:
tolerances cover summation order only.

Also here: the bench scene's pool at rest at 32^3, whose surface velocities
grow frame by frame in both packages alike, and the table engine's drops on
that pool, equal frame by frame in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.ops import pallas_particles as jpp
from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.ops import pallas_particles as tpp
from flipviscosity3d_torch.scripts.bench import bench_scene
from test_torch_particles import DX, FACES, SHAPE, _particles
from test_torch_step import (  # noqa: F401  (scene is a fixture)
    DT,
    JAX_CFG,
    _advance_both,
    _assert_frames_match,
    _assert_substep_matches,
    _jax_substep,
    _moving,
    _port_cfg,
    scene,
)

CAP = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def folds_at_16(monkeypatch):
    """The port's auto rule brought down to 16^3."""
    monkeypatch.setattr(tpp, "FOLD_CELLS", 16 ** 3)


def _port_scatter(form, pos, vel, fold_sums):
    """The port's scatter -> (sums, table, counts or None): "sorted" over
    the tile-key-sorted stream, "stale" over the stream as it is through a
    pass-A plan (budget 8: all 8 tiles of 16^3, so every particle is
    covered and the sums equal the sorted form's)."""
    pos, vel = torch.from_numpy(pos), torch.from_numpy(vel)
    if form == "sorted":
        s = tpp.tiled_sort(pos, vel, DX, SHAPE)
        return (*tpp.scatter_p2g_table(s.pos, s.vel, s.key, s.rank, SHAPE,
                                       DX, CAP, fold_sums=fold_sums), None)
    key = tpp.key_of_position(pos, DX, SHAPE)
    plan = tpp.plan_pass_a(key, SHAPE)
    assert bool(plan.covered.all())
    return tpp.scatter_p2g_table_stale(pos, vel, key, plan, SHAPE, DX, CAP,
                                       fold_sums=fold_sums)


def _jax_scatter_folded(form, pos, vel):
    pos, vel = jnp.asarray(pos), jnp.asarray(vel)
    if form == "sorted":
        s = jpp.tiled_sort(pos, vel, DX, SHAPE)
        return jpp.scatter_p2g_table(s.plan.tabs, s.plan.lockeys, s.payload,
                                     SHAPE, DX, CAP, fold_sums=True)
    key = jpp.key_of_position(pos, DX, SHAPE)
    _, splan = jpp.plan_pass_a(key, pos.shape[0], SHAPE, budget=8,
                               factor=3.0)
    return jpp.scatter_p2g_table(
        splan.tabs, splan.lockeys, jpp.stale_payload(pos, vel, key, SHAPE),
        SHAPE, DX, CAP, inkernel_rank=True, fold_sums=True)


@pytest.mark.parametrize("form", ["sorted", "stale"])
def test_folded_scatter_matches_jax_kernel(form):
    """The plain folded version against JAX's fold_sums=True kernel: shape
    (16, 16, 16*112), lanes < 108 at rtol 1e-5 / atol 1e-6 * max|sums|, the
    four pad lanes exactly 0, and the table slot for slot (the first cap*4
    lanes of each cell of JAX's padded table; the stale form's ranks are
    stream-order ranks on both sides)."""
    pos, vel = _particles()
    tsums, ttbl, _ = _port_scatter(form, pos, vel, True)
    jsums, jtbl = _jax_scatter_folded(form, pos, vel)
    assert tpp.SUML == jpp.SUML == 112
    assert tuple(tsums.shape) == jsums.shape == (16, 16, 16 * 112)
    jcells = np.asarray(jsums).reshape(*SHAPE, 112)
    tcells = tsums.numpy().reshape(*SHAPE, 112)
    np.testing.assert_allclose(
        tcells[..., :108], jcells[..., :108], rtol=1e-5,
        atol=1e-6 * np.abs(jcells).max())
    assert not tcells[..., 108:].any() and not jcells[..., 108:].any()
    jtbl = np.asarray(jtbl).reshape(*SHAPE, -1)[..., :CAP * 4]
    np.testing.assert_array_equal(ttbl.numpy().reshape(*SHAPE, CAP * 4),
                                  jtbl)


@pytest.mark.parametrize("form", ["sorted", "stale"])
def test_folded_scatter_equals_unfolded_exactly(form):
    """Folding only moves the rows: lanes 0..107, table and counts are
    bit-equal to the unfolded version's, the pads 0."""
    pos, vel = _particles()
    fsums, ftbl, fcnt = _port_scatter(form, pos, vel, True)
    usums, utbl, ucnt = _port_scatter(form, pos, vel, False)
    assert tuple(usums.shape) == (*SHAPE, 108)
    cells = fsums.reshape(*SHAPE, 112)
    assert torch.equal(cells[..., :108], usums)
    assert not cells[..., 108:].any()
    assert torch.equal(ftbl, utbl)
    assert form == "sorted" or torch.equal(fcnt, ucnt)


@pytest.mark.parametrize("form", ["sorted", "stale"])
@pytest.mark.parametrize("fold", [False, True])
def test_plain_scatter_in_slabs_equals_whole(form, fold):
    """The plain scatters in 5 runs of particles (how the smoke run fits
    them onto the card at 256^3) give the whole stream's sums, table and
    counts: on the CPU index_add adds in stream order either way, so bit
    for bit."""
    pos, vel = (torch.from_numpy(a) for a in _particles())
    if form == "sorted":
        s = tpp.tiled_sort(pos, vel, DX, SHAPE)
        args = (s.pos, s.vel, s.key, s.rank, SHAPE, DX, CAP, fold)
        ref = tpp.scatter_p2g_table_ref
    else:
        key = tpp.key_of_position(pos, DX, SHAPE)
        covered = torch.from_numpy(
            np.random.default_rng(2).random(pos.shape[0]) < 0.8)
        args = (pos, vel, key, covered, SHAPE, DX, CAP, fold)
        ref = tpp.scatter_p2g_table_stale_ref
    for whole, slabbed in zip(ref(*args), ref(*args, slabs=5)):
        assert torch.equal(whole, slabbed)


def test_scatter_folds_by_the_jax_rule(folds_at_16):
    """fold_sums=None: folded from FOLD_CELLS cells on, JAX's 2^24."""
    assert tpp.large_grid((16, 16, 16)) and not tpp.large_grid((16, 16, 8))
    pos, vel = _particles(n=500)
    assert _port_scatter("sorted", pos, vel, None)[0].shape == (
        16, 16, 16 * 112)
    assert _port_scatter("stale", pos, vel, None)[0].shape == (
        16, 16, 16 * 112)


def test_large_grid_threshold_is_jax_s():
    assert tpp.FOLD_CELLS == 1 << 24
    assert tpp.large_grid((256, 256, 256))
    assert not tpp.large_grid((256, 256, 248))
    assert not tpp.large_grid((128, 128, 128))


def _sums(form):
    rng = np.random.default_rng(5)
    sums = rng.standard_normal((*SHAPE, 108)).astype(np.float32)
    if form == "4d":
        return sums
    if form == "folded108":
        return sums.reshape(16, 16, -1)
    return np.pad(sums, ((0, 0),) * 3 + ((0, 4),)).reshape(16, 16, -1)


@pytest.mark.parametrize("form", ["4d", "folded108", "folded112"])
def test_p2g_combine_slabs_are_bit_equal_and_match_jax(form):
    """1, 4 and 8 i-slabs over the 4D sums, JAX's unpadded fold and the
    scatter's 112-lane fold: bit-equal among themselves (as
    test_p2g_combine_slabbed_matches_fused holds JAX), and equal to JAX's
    p2g_combine of the 4D sums, fused and in 4 slabs, at rtol 1e-6 (the
    same additions in the same order; XLA may fuse them differently)."""
    sums = torch.from_numpy(_sums(form))
    fused = tpp.p2g_combine(sums, SHAPE, FACES, i_slabs=1)
    for slabs in (4, 8):
        got = tpp.p2g_combine(sums, SHAPE, FACES, i_slabs=slabs)
        for (v1, w1), (vs, ws) in zip(fused, got):
            assert torch.equal(v1, vs) and torch.equal(w1, ws), slabs
    jsums = jnp.asarray(_sums("4d"))
    for slabs in (1, 4):
        jout = jpp.p2g_combine(jsums, SHAPE, FACES, i_slabs=slabs)
        for (jv, jw), (tv, tw) in zip(jout, fused):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                       rtol=1e-6, atol=1e-6)


def test_p2g_combine_slabs_by_the_jax_rule(folds_at_16, monkeypatch):
    """i_slabs=None: 8 slabs at a large grid when I % 8 == 0, else fused."""
    seen = []
    real = tpp._combine_cells
    monkeypatch.setattr(tpp, "_combine_cells",
                        lambda lanes, fs: seen.append(lanes.shape[1])
                        or real(lanes, fs))
    sums = torch.from_numpy(_sums("folded112"))
    tpp.p2g_combine(sums, SHAPE, FACES)
    assert seen == [4] * 8          # windows of 16 / 8 + 2 rows
    del seen[:]
    shape20 = (20, 16, 16)
    faces20 = ((21, 16, 16), (20, 17, 16), (20, 16, 17))
    assert tpp.large_grid(shape20)
    tpp.p2g_combine(torch.cat([sums, sums[:4]]), shape20, faces20)
    assert seen == [20]


def _step_equal(a, b):
    (sa, da), (sb, db) = a, b
    assert all(torch.equal(getattr(sa, k), getattr(sb, k))
               for k in ("pos", "vel", "u", "v", "w"))
    assert {k: float(v) for k, v in da.items()} == {
        k: float(v) for k, v in db.items()}


def test_split_gather_equals_fused(scene):
    """Two one-grid gathers (the JAX package's split form of pass A's
    gather) give the rows of the one two-grid gather bit for bit, which is
    why the port takes pallas_split_gather and always gathers fused: a
    substep under True, False and None is torch.equal."""
    base, arrays = scene
    state = state_from_numpy(_moving(arrays), "cpu")
    stream = tpp.tiled_sort(state.pos, state.vel, DX, SHAPE)
    px, py, pz = (stream.pos[:, a].contiguous() for a in range(3))
    rng = np.random.default_rng(3)
    gu, gv, gw = ([torch.from_numpy(rng.standard_normal(fs).astype(
        np.float32)) for _ in range(2)] for fs in FACES)
    fused = tpp.gather_mac(px, py, pz, stream.key, gu, gv, gw, DX, SHAPE)
    split = [tpp.gather_mac(px, py, pz, stream.key, gu[g:g + 1], gv[g:g + 1],
                            gw[g:g + 1], DX, SHAPE) for g in range(2)]
    assert torch.equal(torch.cat(split), fused)
    steps = [tstep.step(state, DT, dataclasses.replace(
        base, pallas_split_gather=value)) for value in (True, False, None)]
    _step_equal(steps[0], steps[1])
    _step_equal(steps[0], steps[2])


def test_large_scene_switches_match_jax(scene, monkeypatch):
    """One substep from a moving state and one frame from rest, against the
    JAX substep with pallas_split_gather=True (one compile of the JAX
    advance serves both), at test_torch_step's tolerances, particles
    element by element:

    - the port with pallas_split_gather=True (taken, and run fused);
    - the port with its auto rule patched to 16^3 and every switch left to
      it: the scatter folds and the combine runs in 8 slabs. Its substep is
      torch.equal to the unfolded, unslabbed one's."""
    base, arrays = scene
    jcfg = dataclasses.replace(JAX_CFG, pallas_split_gather=True)
    moving = _moving(arrays)
    jnew, jd = _jax_substep(moving, 0.01, jcfg)
    state = state_from_numpy(moving, "cpu")

    split = _port_cfg(base, jcfg)
    assert split.pallas_split_gather is True
    _assert_substep_matches(*tstep.step(state, DT, split), jnew, jd)
    plain = tstep.step(state, DT, dataclasses.replace(
        split, pallas_split_gather=False))

    monkeypatch.setattr(tpp, "FOLD_CELLS", 16 ** 3)
    auto = dataclasses.replace(split, pallas_split_gather=None)
    folded = []
    real = tpp.scatter_p2g_table_ref
    monkeypatch.setattr(
        tpp, "scatter_p2g_table_ref",
        lambda *a, **kw: folded.append(a[-1]) or real(*a, **kw))
    large = tstep.step(state, DT, auto)
    assert folded == [True]
    _assert_substep_matches(*large, jnew, jd)
    _step_equal(large, plain)
    _assert_frames_match(*_advance_both(arrays, auto, jcfg, 0.01, 1))


def test_scene_path_reports_the_large_scene_kernels(folds_at_16, tmp_path):
    """What chip_smoke.py drives at 256^3, here at 16^3 on CPU tensors with
    the threshold lowered: the path runs through the scene CLI and names
    the folded scatter as what the card must launch."""
    result = smoke.run_scene_path("cpu", tmp_path, "bench", 16, 1)
    run = result.pop("run")
    assert result["failures"] == []
    assert result["path_kernels"] == [
        "scatter_p2g_table_folded", "liquid_sdf_from_table", "gather_mac",
        "gather_mac_one_grid", "mg_down", "mg_up", "viscosity_operator",
        "compute_volume_grids", "build_viscosity_system"]
    assert set(result["launches"].values()) == {0}
    stale = dataclasses.replace(run.sim.cfg, **smoke.STALE_PATH)
    assert smoke.path_kernels(stale) == [
        "scatter_p2g_table_stale_folded", "liquid_sdf_from_table",
        "gather_mac", "gather_mac_one_grid", "mg_down", "mg_up",
        "viscosity_operator", "compute_volume_grids",
        "build_viscosity_system", "gather_rows8"]


def _resting_pool_frames(res, frames, particle_engine="pallas",
                         bucket_capacity=16):
    """The bench scene's pool at rest at res^3 through `frames` frames of
    0.01 s in both packages on `particle_engine` at `bucket_capacity`,
    under the default engine variants -> (the port's diagnostics per frame,
    the JAX package's)."""
    sim = bench_scene("cpu", res, particle_engine=particle_engine)
    sim.cfg = dataclasses.replace(sim.cfg, bucket_capacity=bucket_capacity)
    jcfg = JaxConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res,
                     bucket_capacity=bucket_capacity,
                     particle_engine=particle_engine)
    cfg = _port_cfg(sim.cfg, jcfg)
    assert cfg == sim.cfg
    _, tds, _, jds = _advance_both(state_to_numpy(sim.state), cfg, jcfg,
                                   0.01, frames)
    return tds, jds


def test_resting_pool_speeds_up_in_both_packages_alike():
    """The bench scene's pool at rest in its box, at 32^3, five frames.
    Gravity alone would add 0.098 m/s per frame to a free fall and nothing
    to a pool at rest; instead a few surface faces reach 0.6 m/s in the
    first frame that has velocities and pass 1 m/s by the fifth, more at
    finer grids (which is what costs the 256^3 bench scene its extra
    substeps). The JAX package does the same, frame by frame: max|u| to
    1e-4, substeps, both solves' iteration counts and the overflow equal.
    So the growth is the algorithm's, not the port's."""
    torch.set_num_threads(1)
    tds, jds = _resting_pool_frames(32, 5)
    for td, jd in zip(tds, jds):
        assert td.substeps == int(jd.substeps) == 1
        assert td.pressure_iterations == int(jd.pressure_iterations)
        assert td.viscosity_iterations == int(jd.viscosity_iterations)
        assert td.bucket_overflow == int(jd.bucket_overflow)
        np.testing.assert_allclose(td.max_velocity, float(jd.max_velocity),
                                   rtol=1e-4)
    speeds = [td.max_velocity for td in tds]
    assert speeds[0] == 0.0 and speeds[1] > 0.5 and speeds[4] > 1.0


def test_table_drops_equal_frame_by_frame_in_both_packages():
    """The "table" engine (the JAX default) on the bench scene's pool at
    32^3, five frames, at a bucket capacity of 10: the pool settles and
    crowds cells past the capacity, and the JAX package drops particles in
    four of the five frames (0, 13, 138, 337, 624 when this test was
    written). The port drops the same particles: bucket_overflow, substeps
    and both solves' iteration counts equal frame by frame, max|u| to
    1e-4."""
    torch.set_num_threads(1)
    tds, jds = _resting_pool_frames(32, 5, "table", 10)
    for td, jd in zip(tds, jds):
        assert td.substeps == int(jd.substeps)
        assert td.pressure_iterations == int(jd.pressure_iterations)
        assert td.viscosity_iterations == int(jd.viscosity_iterations)
        assert td.bucket_overflow == int(jd.bucket_overflow)
        np.testing.assert_allclose(td.max_velocity, float(jd.max_velocity),
                                   rtol=1e-4)
    assert sum(int(jd.bucket_overflow) > 0 for jd in jds) >= 3
