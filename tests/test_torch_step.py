"""The port's substep, advance loop and main path against the JAX package, on
the CPU, at 16^3.

One scene (the template of tests/test_pallas_particles.py) is set up by the
port and handed to both packages as the same numpy state. The JAX reference
is the "pallas" engine under the same pass-A / pass-B / pushback variants as
the port's config. Both packages leave a substep with the particles in the
same order, so particles are compared element by element. A particle within
float noise of a cell face could take another key in one package and
reorder the stream; the seeds below were checked to have none.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.core import step as jstep
from flipviscosity3d_tpu.core.state import SimState as JaxState
from flipviscosity3d_tpu.core.state import SolidBoundary as JaxSolid
from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.sim import FluidSimulation
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.io.trianglemesh import box_mesh

JAX_CFG = JaxConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                    bucket_capacity=16, particle_engine="pallas",
                    pallas_pass_b="sort")
DT = float(np.float32(0.01))


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    sim = FluidSimulation("cpu")
    sim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16,
                   particle_engine="pallas")
    sim.add_liquid(box_mesh((0.2, 0.2, 0.2), (0.8, 0.55, 0.8)))
    sim.set_viscosity(2.0)
    sim.set_gravity(0.0, -9.81, 0.0)
    return sim.cfg, state_to_numpy(sim.state)


def _jax_state(arrays):
    solid = JaxSolid(**{k: jnp.asarray(arrays[k]) for k in JaxSolid._fields})
    return JaxState(solid=solid, **{
        k: jnp.asarray(arrays[k]) for k in JaxState._fields if k != "solid"})


def _moving(arrays):
    """The scene's particles in a rigid rotation plus noise (numpy, seeded);
    grids at rest."""
    rng = np.random.default_rng(0)
    p = arrays["pos"] - np.float32(0.5)
    vel = np.stack([-p[:, 1], p[:, 0], 0.3 * p[:, 2]], axis=1)
    return dict(arrays, vel=(vel + rng.normal(scale=0.05, size=vel.shape))
                .astype(np.float32))


def _port_cfg(cfg, jcfg):
    """The port's config with the JAX config's particle engine, its
    variants and capacities."""
    names = [f.name for f in dataclasses.fields(cfg)
             if f.name.startswith("pallas_") or f.name in (
                 "particle_engine", "bucket_capacity", "sdf_capacity",
                 "cfl_number")]
    return dataclasses.replace(cfg, **{k: getattr(jcfg, k) for k in names})


def _assert_substep_matches(tnew, td, jnew, jd):
    """u, v, w to 1e-5 of max|u|; positions to 1e-6; velocities to 3e-5 of
    their max (the PIC/FLIP blend sums three grid samples), element by
    element; iteration, overflow and liquid-cell counts equal."""
    for name in ("u", "v", "w"):
        j = np.asarray(getattr(jnew, name))
        np.testing.assert_allclose(getattr(tnew, name).numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max(), err_msg=name)
    jv = np.asarray(jnew.vel)
    np.testing.assert_allclose(tnew.pos.numpy(), np.asarray(jnew.pos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tnew.vel.numpy(), jv, rtol=0,
                               atol=3e-5 * np.abs(jv).max())
    assert td["pressure_iterations"] == int(jd["pressure_iterations"])
    assert td["viscosity_iterations"] == int(jd["viscosity_iterations"])
    assert int(td["bucket_overflow"]) == int(jd["bucket_overflow"])
    assert int(td["liquid_cells"]) == int(jd["liquid_cells"])


def _assert_frames_match(ts, tds, js, jds):
    """Substep and CG iteration counts and overflow equal frame by frame;
    positions, velocities and u to rtol 2e-3 / atol 2e-4, as
    tests/test_pallas_particles.py:426-436 holds the JAX engines."""
    for td, jd in zip(tds, jds):
        assert td.substeps == int(jd.substeps)
        assert td.pressure_iterations == int(jd.pressure_iterations)
        assert td.viscosity_iterations == int(jd.viscosity_iterations)
        assert td.bucket_overflow == int(jd.bucket_overflow)
        np.testing.assert_allclose(td.max_velocity, float(jd.max_velocity),
                                   rtol=1e-5)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(ts.vel.numpy(), np.asarray(js.vel),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=2e-3,
                               atol=2e-4)


def _advance_both(arrays, cfg, jcfg, dt, frames):
    js, ts = _jax_state(arrays), state_from_numpy(arrays, "cpu")
    jds, tds = [], []
    for _ in range(frames):
        js, jd = jstep.advance(js, dt, jcfg)
        ts, td = tstep.advance(ts, dt, cfg)
        jds.append(jd)
        tds.append(td)
    return ts, tds, js, jds


def _jax_substep(arrays, dt, jcfg):
    """One JAX `advance` of a whole dt from grids at rest: exactly one
    substep (substep_idx 0)."""
    jnew, jd = jstep.advance(_jax_state(arrays), dt, jcfg)
    assert int(jd.substeps) == 1
    return jnew, {k: getattr(jd, k) for k in (
        "pressure_iterations", "viscosity_iterations", "bucket_overflow",
        "liquid_cells")}


def test_substep_and_two_frames_match_jax(scene):
    """One test, so both halves share one compile of the JAX advance, under
    pass A "sort", pass B "sort" and the gather pushback.

    One substep from a moving state, element by element
    (_assert_substep_matches). Two frames of advance from rest
    (_assert_frames_match; observed at this scene: each solve's last
    residual is <= 0.71 of its tolerance and the one before >= 1.33 of it,
    so no count sits at the boundary)."""
    base, arrays = scene
    cfg = _port_cfg(base, JAX_CFG)
    moving = _moving(arrays)
    jnew, jd = _jax_substep(moving, 0.01, JAX_CFG)
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), DT, cfg)
    _assert_substep_matches(tnew, td, jnew, jd)
    _assert_frames_match(*_advance_both(arrays, cfg, JAX_CFG, 0.01, 2))


def test_split_terms_two_substep_and_frame_match_jax(scene):
    """pallas_split_terms=2 (the JAX package's two-term split of its
    scatter and gather products, which the port rounds the same way): one
    substep from the moving state (_assert_substep_matches) and one frame
    of advance from rest (_assert_frames_match), at the tolerances of the
    exact-product test above. The rounding acts: the port's substep at
    terms 3 ends elsewhere."""
    base, arrays = scene
    jcfg = dataclasses.replace(JAX_CFG, pallas_split_terms=2)
    cfg = _port_cfg(base, jcfg)
    assert cfg.pallas_split_terms == 2
    moving = _moving(arrays)
    jnew, jd = _jax_substep(moving, 0.01, jcfg)
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), DT, cfg)
    _assert_substep_matches(tnew, td, jnew, jd)
    exact, _ = tstep.step(state_from_numpy(moving, "cpu"), DT,
                          _port_cfg(base, JAX_CFG))
    assert not torch.equal(exact.u, tnew.u)
    assert not torch.equal(exact.vel, tnew.vel)
    _assert_frames_match(*_advance_both(arrays, cfg, jcfg, 0.01, 1))


def test_pass_b_sort_keeps_jax_order_with_overflowing_table(scene):
    """Pass B "sort" re-sorts the particles by midpoint key, as JAX does:
    with an SDF capacity of 2 the slot table overflows, so the next pass A
    (a stable sort of that order) fills the table with the same particles
    as JAX only if the order is the same. One substep element by element,
    then two frames."""
    base, arrays = scene
    jcfg = dataclasses.replace(JAX_CFG, sdf_capacity=2)
    cfg = _port_cfg(base, jcfg)
    moving = _moving(arrays)
    jnew, jd = _jax_substep(moving, 0.01, jcfg)
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), DT, cfg)
    assert int(td["bucket_overflow"]) > 0
    _assert_substep_matches(tnew, td, jnew, jd)
    ts, tds, js, jds = _advance_both(
        state_to_numpy(tnew), cfg, jcfg, 0.01, 2)
    assert all(td.bucket_overflow > 0 for td in tds)
    _assert_frames_match(ts, tds, js, jds)


def test_gather_dtype_bf16_substep_matches_jax(scene):
    """One substep from the moving state under pallas_gather_dtype="bf16":
    the JAX step stores its gather image in bf16, the port rounds the grids
    it gathers from; element by element at the f32 step test's tolerances
    (_assert_substep_matches). The rounding acts: the port's own f32 step
    ends elsewhere. Any other value raises."""
    base, arrays = scene
    jcfg = dataclasses.replace(JAX_CFG, pallas_gather_dtype="bf16")
    cfg = _port_cfg(base, jcfg)
    assert cfg.pallas_gather_dtype == "bf16"
    assert base.pallas_gather_dtype == "f32"
    moving = _moving(arrays)
    jnew, jd = _jax_substep(moving, 0.01, jcfg)
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), DT, cfg)
    _assert_substep_matches(tnew, td, jnew, jd)
    fnew, _ = tstep.step(state_from_numpy(moving, "cpu"), DT,
                         _port_cfg(base, JAX_CFG))
    assert torch.equal(fnew.u, tnew.u)   # the grids in the state stay f32
    assert not torch.equal(fnew.pos, tnew.pos)
    assert not torch.equal(fnew.vel, tnew.vel)
    with pytest.raises(ValueError, match="pallas_gather_dtype"):
        dataclasses.replace(base, pallas_gather_dtype="f16")


STALE = dict(pallas_pass_a="stale", pallas_pass_b="plan",
             pallas_pushback="kernel", pallas_passa_budget=2,
             pallas_midpoint_budget=2)


def test_stale_plan_kernel_substep_matches_jax(scene):
    """One substep at substep_idx=1 (no re-sort: the plans run over the
    seeding order) with stale pass A, the midpoint plan and the kernel
    pushback, budgets of 2 so that each plan leaves particles uncovered:
    element by element (_assert_substep_matches)."""
    base, arrays = scene
    jcfg = dataclasses.replace(JAX_CFG, **STALE)
    cfg = _port_cfg(base, jcfg)
    moving = _moving(arrays)
    jstep_jit = jax.jit(jstep.step, static_argnames=("cfg",))
    jnew, jd = jstep_jit(_jax_state(moving), jnp.float32(0.01), cfg=jcfg,
                         substep_idx=jnp.int32(1))
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), DT, cfg,
                          substep_idx=1)
    assert int(td["bucket_overflow"]) > 0
    _assert_substep_matches(tnew, td, jnew, jd)


def test_stale_plan_kernel_two_frames_match_jax(scene):
    """Two frames of 0.08 s of advance from the moving state with stale
    pass A re-sorted every 2 substeps and cfl_number 0.5, so that the second
    frame takes several substeps and some run stale (substep 0 of every
    frame re-sorts; the first frame is one substep, from grids at rest):
    _assert_frames_match."""
    base, arrays = scene
    jcfg = dataclasses.replace(JAX_CFG, cfl_number=0.5,
                               pallas_resort_every=2, **STALE)
    cfg = _port_cfg(base, jcfg)
    ts, tds, js, jds = _advance_both(_moving(arrays), cfg, jcfg, 0.08, 2)
    assert sum(td.stale_substeps for td in tds) >= 1
    _assert_frames_match(ts, tds, js, jds)


def test_main_path_runs_on_cpu():
    """run_main_path is what chip_smoke.py drives at 128^3 on the card; here
    at 16^3 on CPU tensors, where every kernel wrapper takes its plain
    version (so no launch is counted)."""
    torch.set_num_threads(1)
    result = smoke.run_main_path("cpu", 16, 2, log=lambda line: None)
    assert result["failures"] == []
    assert result["particles"] > 0 and result["substeps"] >= 2
    assert result["launches"] == {
        "scatter_p2g_table": 0, "gather_mac": 0, "gather_mac_one_grid": 0,
        "mg_down": 0, "mg_up": 0,
        "scatter_p2g_table_stale": 0, "gather_rows8": 0,
        "scatter_p2g_table_folded": 0, "scatter_p2g_table_stale_folded": 0,
        "gather_rows": 0, "detile": 0, "scatter_revisit": 0,
        "gather_revisit": 0, "tile_scatter": 0, "tile_gather": 0,
        "viscosity_operator": 0, "compute_volume_grids": 0,
        "build_viscosity_system": 0}
    assert result["path_kernels"] == [
        "scatter_p2g_table", "gather_mac", "gather_mac_one_grid", "mg_down",
        "mg_up", "viscosity_operator", "compute_volume_grids",
        "build_viscosity_system"]
    assert all(f["viscosity_iterations"] > 0 for f in result["frames"])
    # the midpoint plan's demand, per chunk: at least one visit
    assert all(f["plan_demand"] >= 1 for f in result["frames"])


def test_stale_main_path_runs_on_cpu():
    """chip_smoke.py's second path (the pool lifted so that it falls, stale
    pass A, midpoint plan, kernel pushback) at 16^3 on CPU tensors. Cells
    8 times wider than at 128^3 allow 8 times longer substeps, so the CFL
    number drops to 0.5 to keep several substeps per frame, some stale."""
    torch.set_num_threads(1)
    name, dt, lift, overrides = smoke.MAIN_PATHS[1]
    assert name == "stale"
    result = smoke.run_main_path("cpu", 16, 3, dt=dt, lift=lift,
                                 log=lambda line: None, cfl_number=0.5,
                                 **overrides)
    assert result["failures"] == []
    assert result["substeps"] > 2 and result["stale_substeps"] >= 1
    assert result["path_kernels"] == [
        "scatter_p2g_table_stale", "gather_mac", "gather_mac_one_grid",
        "mg_down", "mg_up", "viscosity_operator", "compute_volume_grids",
        "build_viscosity_system", "gather_rows8"]
    assert all(f["plan_demand"] >= 1 for f in result["frames"])


def test_bench_sort_main_path_runs_on_cpu():
    """chip_smoke.py's third path (the bench scene with pass B "sort", the
    re-sort by midpoint key) at 16^3 on CPU tensors: no visit plan runs."""
    torch.set_num_threads(1)
    name, dt, lift, overrides = smoke.MAIN_PATHS[2]
    assert name == "bench_sort" and overrides == {"pallas_pass_b": "sort"}
    result = smoke.run_main_path("cpu", 16, 2, dt=dt, lift=lift,
                                 log=lambda line: None, **overrides)
    assert result["failures"] == []
    assert result["substeps"] >= 2 and result["stale_substeps"] == 0
    assert result["path_kernels"] == [
        "scatter_p2g_table", "gather_mac", "gather_mac_one_grid", "mg_down",
        "mg_up", "viscosity_operator", "compute_volume_grids",
        "build_viscosity_system"]
    assert all(f["plan_demand"] == 0 and f["uncovered_pass_b"] == 0
               for f in result["frames"])
