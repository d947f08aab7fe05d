"""The port's slab pipeline (flipviscosity3d_torch/parallel/shard_step.py) on
the CPU, on LocalGroups of rank-threads (and one DistGroup over gloo).

The scene is tests/test_shard_step.py's: 32^3, a box of liquid, viscosity
1.5, set up by the port and handed to both packages as one numpy state
(core.state.state_from_numpy). Against the JAX package's advance_sharded on
the conftest's forced host devices (Pallas in interpret mode): the same
substeps and overflow, iterations within 1, the particle multisets within
atol 1e-5 ("stream") / 5e-4 ("pallas"), the owned rows of u within 5e-4.
Against the port's own single-device advance: JAX's multigrid, migration,
inviscid and DCN-layout tests, at their tolerances.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.sim import FluidSimulation
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.io.trianglemesh import box_mesh
from flipviscosity3d_torch.parallel import shard_step as sh
from flipviscosity3d_torch.parallel import slab_mg
from flipviscosity3d_torch.parallel.collectives import LocalGroup
from flipviscosity3d_torch.parallel.sharding import make_mesh, make_slab_mesh
from flipviscosity3d_torch.scripts import shard_collectives
from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.ops import pallas_particles as jpp
from flipviscosity3d_tpu.parallel import shard_step as jsh
from test_torch_step import _jax_state

N = 32
NDEV = 4
DT = 0.01
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    sim = FluidSimulation("cpu")
    sim.initialize(N, N, N, 1.0 / N, pressure_preconditioner="jacobi",
                   viscosity_preconditioner="jacobi")
    sim.add_liquid(box_mesh((0.2, 0.25, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(1.5)
    sim.set_gravity(0.0, -9.81, 0.0)
    return sim.cfg, state_to_numpy(sim.state)


def _jax_cfg(cfg):
    return JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})


def _port_frames(arrays, cfg, frames, group=None, n=NDEV):
    """`frames` frames of advance_sharded -> (ShardedSim, diags, spec)."""
    state = state_from_numpy(arrays, "cpu")
    spec = sh.make_spec(cfg, n, n_particles=state.pos.shape[0])
    group = group or LocalGroup(n, "cpu", timeout=120)
    ss = sh.shard_simstate(state, cfg, spec, group)
    diags = []
    for _ in range(frames):
        ss, d = sh.advance_sharded(ss, DT, cfg, spec, group)
        diags.append(d)
    return ss, diags, spec


def _jax_frames(arrays, jcfg, frames):
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (jsh.AXIS,))
    state = _jax_state(arrays)
    spec = jsh.make_spec(jcfg, NDEV, n_particles=state.pos.shape[0])
    ss = jsh.shard_simstate(state, jcfg, spec)
    diags = []
    for _ in range(frames):
        ss, d = jsh.advance_sharded(ss, DT, jcfg, spec, mesh)
        diags.append(d)
    return ss, diags, spec


def _single_frames(arrays, cfg, frames):
    state = state_from_numpy(arrays, "cpu")
    diags = []
    for _ in range(frames):
        state, d = tstep.advance(state, DT, cfg)
        diags.append(d)
    return state, diags


def _sorted(pos):
    return np.sort(np.asarray(pos), axis=0)


@pytest.mark.parametrize("engine, frames, atol", [
    ("stream", 2, 1e-5),
    ("pallas", 1, 5e-4),
])
def test_sharded_step_matches_jax(scene, engine, frames, atol):
    """advance_sharded of both packages on 4 slabs, frame by frame: equal
    substeps and overflow, pressure and viscosity iterations within 1;
    at the end the particle multisets within `atol` and the owned rows of
    u within 5e-4."""
    base, arrays = scene
    cfg = dataclasses.replace(base, particle_engine=engine)
    tss, tds, spec = _port_frames(arrays, cfg, frames)
    jss, jds, jspec = _jax_frames(arrays, _jax_cfg(cfg), frames)
    assert tuple(spec) == tuple(jspec)
    for td, jd in zip(tds, jds):
        assert td.substeps == int(jd.substeps)
        assert td.bucket_overflow == int(jd.bucket_overflow) == 0
        assert abs(td.pressure_iterations - int(jd.pressure_iterations)) <= 1
        assert abs(td.viscosity_iterations
                   - int(jd.viscosity_iterations)) <= 1
        assert td.liquid_cells == int(jd.liquid_cells)
    tpos, _ = sh.gather_particles(tss)
    jpos, _ = jsh.gather_particles(jss)
    assert tpos.shape == jpos.shape
    np.testing.assert_allclose(_sorted(tpos), _sorted(jpos), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(sh.gather_grid_u(tss, spec),
                               jsh.gather_grid_u(jss, jspec), rtol=0,
                               atol=5e-4)


def test_multigrid_matches_single_device(scene):
    """MG-PCG on both solves: the slab hierarchy is the single-device one,
    so iteration counts agree within 1 per frame (the JAX test allows a
    quarter), positions within 5e-4, over 2 frames."""
    base, arrays = scene
    cfg = dataclasses.replace(base, pressure_preconditioner="multigrid",
                              viscosity_preconditioner="multigrid")
    ss, mds, spec = _port_frames(arrays, cfg, 2)
    state, sds = _single_frames(arrays, cfg, 2)
    for sd, md in zip(sds, mds):
        assert sd.substeps == md.substeps
        assert abs(sd.pressure_iterations - md.pressure_iterations) <= 1
        assert abs(sd.viscosity_iterations - md.viscosity_iterations) <= 1
        assert md.viscosity_solves == sd.viscosity_solves == sd.substeps
        assert md.viscosity_unconverged == sd.viscosity_unconverged == 0
    pos, _ = sh.gather_particles(ss)
    np.testing.assert_allclose(_sorted(pos), _sorted(state.pos), atol=5e-4)


def test_multigrid_sharded_step_against_jax(scene, monkeypatch):
    """MG-PCG on both solves (mg_backend "xla", as JAX's multigrid test),
    one frame of advance_sharded on 4 slabs in both packages. The pressure
    hierarchies are the same: iterations within 1. The viscosity ones
    differ by design (slab_mg's docstring): JAX's leaves out the padding
    row of the single-device blocks. With that row left out of the port's
    too, its counts are JAX's within 1 and its particles JAX's within
    5e-4; with the row, the port's viscosity count is its single-device
    one within 1, and the gap to JAX's is what the row makes."""
    base, arrays = scene
    cfg = dataclasses.replace(base, pressure_preconditioner="multigrid",
                              viscosity_preconditioner="multigrid",
                              mg_backend="xla")
    jss, (jd,), _ = _jax_frames(arrays, _jax_cfg(cfg), 1)
    _, (td,), _ = _port_frames(arrays, cfg, 1)
    _, (sd,) = _single_frames(arrays, cfg, 1)
    build = slab_mg.build_slab_hierarchy
    monkeypatch.setattr(
        slab_mg, "build_slab_hierarchy",
        lambda diag, links, cfg, group, extra_rows=0: build(
            diag, links, cfg, group))
    tss, (xd,), _ = _port_frames(arrays, cfg, 1)
    for d in (td, xd):
        assert d.substeps == int(jd.substeps)
        assert d.bucket_overflow == int(jd.bucket_overflow) == 0
        assert abs(d.pressure_iterations - int(jd.pressure_iterations)) <= 1
    assert abs(xd.viscosity_iterations - int(jd.viscosity_iterations)) <= 1
    assert abs(td.viscosity_iterations - sd.viscosity_iterations) <= 1
    assert abs(td.viscosity_iterations - int(jd.viscosity_iterations)) == \
        abs(td.viscosity_iterations - xd.viscosity_iterations) > 1
    tpos, _ = sh.gather_particles(tss)
    jpos, _ = jsh.gather_particles(jss)
    np.testing.assert_allclose(_sorted(tpos), _sorted(jpos), rtol=0,
                               atol=5e-4)


def test_migration_moves_particles(scene):
    """A uniform +x drift of 2 m/s pushes particles across slab faces:
    occupancy changes, none is lost, every alive particle sits in its
    slab's rows, and the cloud matches the single-device engine (5e-4)."""
    base, arrays = scene
    vel = np.zeros_like(arrays["vel"])
    vel[:, 0] = 2.0
    arrays = dict(arrays, vel=vel)
    state = state_from_numpy(arrays, "cpu")
    spec = sh.make_spec(base, NDEV, n_particles=state.pos.shape[0])
    group = LocalGroup(NDEV, "cpu", timeout=120)
    ss = sh.shard_simstate(state, base, spec, group)
    occ0 = ss.alive.sum(dim=1)
    migrated = 0
    for _ in range(3):
        state, _ = tstep.advance(state, DT, base)
        ss, d = sh.advance_sharded(ss, DT, base, spec, group)
        assert d.bucket_overflow == 0 and d.migration_lost == 0
        migrated += d.migrated
    occ1 = ss.alive.sum(dim=1)
    assert int(occ1.sum()) == int(occ0.sum())
    assert migrated > 0 and not torch.equal(occ0, occ1)
    for s in range(NDEV):
        xs = ss.pos[s][ss.alive[s], 0].numpy()
        owner = np.floor(xs / base.dx).astype(int) // spec.B
        np.testing.assert_array_equal(np.clip(owner, 0, NDEV - 1), s)
    pos, _ = sh.gather_particles(ss)
    np.testing.assert_allclose(_sorted(pos), _sorted(state.pos), atol=5e-4)


def test_inviscid_frame_matches_single_device(scene):
    """Viscosity 0 everywhere: the viscosity switch (a pmax) is off on
    every rank, 0 iterations; positions match the single device (5e-4)."""
    base, arrays = scene
    arrays = dict(arrays, viscosity=np.zeros_like(arrays["viscosity"]))
    ss, (md,), _ = _port_frames(arrays, base, 1)
    state, (sd,) = _single_frames(arrays, base, 1)
    assert md.substeps == sd.substeps
    assert md.viscosity_iterations == 0 == sd.viscosity_iterations
    assert md.viscosity_solves == 0 == sd.viscosity_solves
    pos, _ = sh.gather_particles(ss)
    np.testing.assert_allclose(_sorted(pos), _sorted(state.pos), atol=5e-4)


def test_dcn_slab_mesh_matches_flat_mesh(scene):
    """make_slab_mesh(2 hosts x 2) runs the same program as make_mesh(4):
    one frame on each, equal diagnostics and equal particles."""
    base, arrays = scene
    flat = make_mesh(NDEV, device="cpu")
    dcn = make_slab_mesh(2, NDEV // 2, device="cpu")
    assert dcn.size == NDEV
    ss_f, (d_f,), _ = _port_frames(arrays, base, 1, group=flat)
    ss_d, (d_d,), _ = _port_frames(arrays, base, 1, group=dcn)
    assert d_f == d_d
    assert torch.equal(ss_f.pos, ss_d.pos)


def test_uncovered_count_equals_jax_dead_row_arithmetic():
    """The port counts pass A's uncovered particles as (~covered) & alive;
    the JAX module subtracts the dead rows from all uncovered ones
    (shard_step.py:343-346). With dead rows in the slab and a pass-A budget
    tight enough to leave particles uncovered, no dead row is covered and
    the two counts agree."""
    shape = (24, 32, 32)
    dx = 1.0 / 32
    rng = np.random.default_rng(5)
    n, dead = 6000, 1500
    pos = (rng.uniform(0.05, 0.95, size=(n, 3)) * np.array(shape) * dx
           ).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    alive[rng.choice(n, dead, replace=False)] = False
    cfg = SimConfig(isize=32, jsize=32, ksize=32, dx=dx,
                    particle_engine="pallas", pallas_passa_budget=2,
                    pallas_passa_factor=1.5)
    faces = (shape, (24, 33, 32), (24, 32, 33))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (*pos.T, *vel.T)]
    out = sh._pass_a_pallas(*t, torch.from_numpy(alive), cfg, shape, faces,
                            torch.ones(shape))
    uncovered = int(out[-1])

    key = np.where(alive, np.asarray(jpp.key_of_position(
        jnp.asarray(pos), dx, shape)), np.iinfo(np.int32).max)
    key_s = np.sort(key, kind="stable")
    gplan, _ = jpp.plan_pass_a(jnp.asarray(key_s), n, shape,
                               cfg.pallas_passa_budget,
                               cfg.pallas_passa_factor)
    covered = np.asarray(gplan.covered)[:n]
    dead_rows = key_s == np.iinfo(np.int32).max
    assert not covered[dead_rows].any()
    jax_count = int((~covered).sum()) - int(dead_rows.sum())
    assert uncovered == jax_count > 0


def test_a_faulting_rank_makes_advance_sharded_raise(scene, monkeypatch):
    """Rank 2 raises in its migration: advance_sharded raises that error on
    the calling thread, well inside the barrier timeout."""
    base, arrays = scene
    migrate = sh._migrate

    def faulty(*args):
        if args[-1].rank == 2:
            raise FloatingPointError("rank 2 fault")
        return migrate(*args)

    monkeypatch.setattr(sh, "_migrate", faulty)
    group = LocalGroup(NDEV, "cpu", timeout=20)
    t0 = time.perf_counter()
    with pytest.raises(FloatingPointError, match="rank 2 fault"):
        _port_frames(arrays, base, 1, group=group)
    assert time.perf_counter() - t0 < 20


_DIST_CHILD = """
import json, sys
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, {root!r})
from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.core.state import state_from_numpy
from flipviscosity3d_torch.parallel import shard_step as sh
from flipviscosity3d_torch.parallel.collectives import DistGroup
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", store=dist.FileStore({store!r}, 2),
                        rank=rank, world_size=2)
cfg = SimConfig(**json.load(open({cfg!r})))
state = state_from_numpy(dict(np.load({state!r})), "cpu")
spec = sh.make_spec(cfg, 2, n_particles=state.pos.shape[0])
group = DistGroup()
ss = sh.shard_simstate(state, cfg, spec, group)
ss, d = sh.advance_sharded(ss, {dt!r}, cfg, spec, group)
np.savez({out!r}.format(rank), **{{k: getattr(ss, k).numpy() for k in
         ("pos", "vel", "alive", "u", "v", "w")}})
json.dump(d.as_dict(), open({out!r}.format(rank) + ".json", "w"))
dist.destroy_process_group()
"""


def test_dist_group_over_gloo_equals_local_group(scene, tmp_path):
    """Two processes on a gloo DistGroup (a FileStore under tmp_path) run
    one frame; each slab equals the LocalGroup of 2's: diagnostics and
    alive rows exactly, floats within rtol 1e-6."""
    base, arrays = scene
    np.savez(tmp_path / "state.npz", **arrays)
    (tmp_path / "cfg.json").write_text(json.dumps(dataclasses.asdict(base)))
    out = str(tmp_path / "slab{}.npz")
    code = _DIST_CHILD.format(root=ROOT, store=str(tmp_path / "store"),
                              cfg=str(tmp_path / "cfg.json"),
                              state=str(tmp_path / "state.npz"), dt=DT,
                              out=out)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    ss, (d,), _ = _port_frames(arrays, base, 1, n=2)
    for r in range(2):
        got = np.load(out.format(r))
        gd = json.load(open(out.format(r) + ".json"))
        want = dataclasses.asdict(d)
        want["slab_uncovered"] = [list(want["slab_uncovered"][r])]
        assert gd == want
        assert np.array_equal(got["alive"][0], ss.alive[r].numpy())
        for k in ("pos", "vel", "u", "v", "w"):
            np.testing.assert_allclose(got[k][0], getattr(ss, k)[r].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("n, halo_width, cfl", [
    (3, 6, 5.0),     # 32 rows do not split into 3 slabs
    (8, 6, 5.0),     # slab width 4 < halo 6
    (4, 10, 9.0),    # slab width 8 <= the CFL number 9
    (2, 4, 5.0),     # halo 4 < cfl_number + 1
])
def test_make_spec_refuses_what_jax_refuses(n, halo_width, cfl):
    cfg = SimConfig(isize=N, jsize=N, ksize=N, dx=1.0 / N, cfl_number=cfl)
    with pytest.raises(ValueError) as jerr:
        jsh.make_spec(_jax_cfg(cfg), n, halo_width=halo_width)
    with pytest.raises(ValueError) as terr:
        sh.make_spec(cfg, n, halo_width=halo_width)
    assert str(terr.value) == str(jerr.value)


def test_make_spec_widens_the_halo_for_the_pallas_engine():
    for engine in ("stream", "pallas"):
        cfg = SimConfig(isize=N, jsize=N, ksize=N, dx=1.0 / N,
                        particle_engine=engine)
        assert sh.make_spec(cfg, NDEV, n_particles=1000) == tuple(
            jsh.make_spec(_jax_cfg(cfg), NDEV, n_particles=1000))


def test_collective_audit_on_the_cpu():
    """scripts/shard_collectives at 32^3 on 4 slabs: Jacobi all-gathers
    nothing; under multigrid only the slab V-cycle's tail all-gathers; the
    halo exchanges move (B+2H)-row slabs' H-row windows."""
    result = shard_collectives.run("cpu", res=32, ndev=4)
    assert result["ok"]
    jac, mgr = result["audits"]
    assert jac["substeps"] == 1 and jac["all_gathers"] == 0
    assert mgr["all_gathers"] > 0
    assert {c["caller"] for c in mgr["calls"]
            if c["kind"] == "all_gather"} == {"_gather_rows"}
    shapes = {tuple(c["shape"]) for c in jac["calls"]
              if c["caller"] == "halo_exchange_many"}
    assert shapes == {(jac["H"], N, N), (jac["H"], N + 1, N),
                      (jac["H"], N, N + 1)}


def test_smoke_sharded_paths_run_on_the_cpu(tmp_path):
    """chip_smoke's sharded paths at 32^3 on the CPU's plain versions:
    run_sharded_path on 2 slabs ("pallas", a warm frame held against the
    single-device run, one timed frame) and run_sharded_dist on a gloo
    DistGroup of world size 1 against a LocalGroup of one rank."""
    result = smoke.run_sharded_path("cpu", 32, 1, n_slabs=2,
                                    log=lambda line: None)
    assert result["failures"] == []
    assert [f["warm"] for f in result["frames"]] == [True, False]
    assert result["vs_single_device"]["pos"] <= smoke.SHARDED_ATOL
    assert result["frames"][0]["collectives_per_substep"]["psum"]["calls"]
    dist = smoke.run_sharded_dist("cpu", 32, str(tmp_path / "store"),
                                  log=lambda line: None)
    assert dist["failures"] == []
    assert dist["diffs"]["pos"] == 0.0


def test_slab_kernel_checks_run_on_the_cpu():
    """check_kernels' checks at the sharded paths' inputs (smoke's
    _slab_checks) at 32^3 on the CPU's plain versions: one slab's local
    grid of B + 2H rows and its key-sorted stream with dead rows, every
    check ok, the alive rows all covered."""
    sim = smoke.bench_scene("cpu", N)
    gen = torch.Generator().manual_seed(0)
    checks = smoke._slab_checks(sim.state, sim.cfg, gen, 1)
    assert sorted(checks) == ["gather_mac", "gather_mac_one_grid",
                              "scatter_p2g_table_stale"]
    coverage = checks["scatter_p2g_table_stale"][0]
    assert coverage["check"].startswith("slab 1 of 4 (24x32x32, ")
    assert "dead rows" in coverage["check"]
    assert coverage["covered"] == coverage["alive"] > 0
    assert [len(c) for c in checks.values()] == [7, 3, 3]
    assert all(c["ok"] for cs in checks.values() for c in cs)
