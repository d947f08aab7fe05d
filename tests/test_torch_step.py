"""The port's substep, advance loop and main path against the JAX package, on
the CPU, at 16^3.

One scene (the template of tests/test_pallas_particles.py) is set up by the
port and handed to both packages as the same numpy state. The JAX reference
is the "pallas" engine with pass B = "sort", the semantics the port
implements (its JAX default pass B falls back to ballistic motion past a
visit budget). JAX re-sorts particles by midpoint in pass B and the port
keeps the pass-A order, so particles are compared as multisets (paired by
nearest position).
"""

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


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    sim = FluidSimulation("cpu")
    sim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16)
    sim.add_liquid(box_mesh((0.2, 0.2, 0.2), (0.8, 0.55, 0.8)))
    sim.set_viscosity(2.0)
    sim.set_gravity(0.0, -9.81, 0.0)
    return sim.cfg, state_to_numpy(sim.state)


def _jax_state(arrays):
    solid = JaxSolid(**{k: jnp.asarray(arrays[k]) for k in JaxSolid._fields})
    return JaxState(solid=solid, **{
        k: jnp.asarray(arrays[k]) for k in JaxState._fields if k != "solid"})


def _paired(tpos, tvel, jpos, jvel):
    """Both packages' particles in one order: each port particle is paired
    with its nearest JAX particle (the pairing must be one-to-one). Sorting
    rows lexicographically is not enough: clamped particles share a
    coordinate exactly, so 1e-7 noise in another one reorders them."""
    tpos, tvel = np.asarray(tpos, np.float64), np.asarray(tvel)
    jpos, jvel = np.asarray(jpos, np.float64), np.asarray(jvel)
    nearest = np.concatenate([
        np.argmin(((tpos[i:i + 512, None] - jpos[None]) ** 2).sum(-1), 1)
        for i in range(0, len(tpos), 512)])
    assert len(np.unique(nearest)) == len(tpos)
    return tpos, tvel, jpos[nearest], jvel[nearest]


def test_substep_and_two_frames_match_jax(scene):
    """One test, so both halves share one compile of the JAX advance.

    One substep from a moving state (particles in a rigid rotation plus
    noise, made with numpy; grids at rest, so the JAX advance loop runs
    exactly one `step` of the whole dt): u, v, w to 1e-5 of max|u|;
    positions as multisets to 1e-6; velocities to 3e-5 of their max (the
    PIC/FLIP blend sums three grid samples); iteration and overflow counts
    equal.

    Two frames of advance from rest: substep and CG iteration counts equal
    frame by frame (observed at this scene: each solve's last residual is
    <= 0.71 of its tolerance and the one before >= 1.33 of it, so no count
    sits at the boundary); positions, velocities
    and u to rtol 2e-3 / atol 2e-4, as tests/test_pallas_particles.py:426-436
    holds the JAX engines."""
    cfg, arrays = scene
    rng = np.random.default_rng(0)
    p = arrays["pos"] - np.float32(0.5)
    vel = np.stack([-p[:, 1], p[:, 0], 0.3 * p[:, 2]], axis=1)
    moving = dict(arrays, vel=(vel + rng.normal(scale=0.05, size=vel.shape))
                  .astype(np.float32))
    jnew, jd = jstep.advance(_jax_state(moving), 0.01, JAX_CFG)
    assert int(jd.substeps) == 1
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), 0.01, cfg)
    for name in ("u", "v", "w"):
        j = np.asarray(getattr(jnew, name))
        np.testing.assert_allclose(getattr(tnew, name).numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max(), err_msg=name)
    tp, tv, jp, jv = _paired(tnew.pos, tnew.vel, jnew.pos, jnew.vel)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=3e-5 * np.abs(jv).max())
    assert td["pressure_iterations"] == int(jd.pressure_iterations)
    assert td["viscosity_iterations"] == int(jd.viscosity_iterations)
    assert int(td["bucket_overflow"]) == int(jd.bucket_overflow)
    assert int(td["liquid_cells"]) == int(jd.liquid_cells)

    js, ts = _jax_state(arrays), state_from_numpy(arrays, "cpu")
    for _ in range(2):
        js, jd = jstep.advance(js, 0.01, JAX_CFG)
        ts, td = tstep.advance(ts, 0.01, cfg)
        assert td.substeps == int(jd.substeps)
        assert td.pressure_iterations == int(jd.pressure_iterations)
        assert td.viscosity_iterations == int(jd.viscosity_iterations)
        assert td.bucket_overflow == int(jd.bucket_overflow)
        np.testing.assert_allclose(td.max_velocity, float(jd.max_velocity),
                                   rtol=1e-5)
    tp, tv, jp, jv = _paired(ts.pos, ts.vel, js.pos, js.vel)
    np.testing.assert_allclose(tp, jp, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(tv, jv, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=2e-3,
                               atol=2e-4)


def test_main_path_runs_on_cpu():
    """run_main_path is what chip_smoke.py drives at 128^3 on the card; here
    at 16^3 on CPU tensors, where every kernel wrapper takes its plain
    version (so no launch is counted)."""
    torch.set_num_threads(1)
    result = smoke.run_main_path("cpu", 16, 2, log=lambda line: None)
    assert result["failures"] == []
    assert result["particles"] > 0 and result["substeps"] >= 2
    assert result["launches"] == {
        "scatter_p2g_table": 0, "gather_mac": 0, "mg_down": 0, "mg_up": 0}
    assert all(f["viscosity_iterations"] > 0 for f in result["frames"])
