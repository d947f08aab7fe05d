"""The port's pressure and viscosity solves against the JAX package, on the
CPU, on one bridged 16^3 scene: the liquid SDF of its seeded particles, its
solid boundary, and velocity grids made with numpy from a seed.

The systems are assembled with the same arithmetic (rtol 1e-6); the CG
solves must take the same number of iterations, and their solutions agree
to 1e-5 of their largest entry (summation order in the dots and the coarse
dense inverse differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.solvers import pressure as jps
from flipviscosity3d_tpu.solvers import viscosity as jvs
from flipviscosity3d_torch.core.sim import FluidSimulation
from flipviscosity3d_torch.io.trianglemesh import box_mesh
from flipviscosity3d_torch.ops import pallas_particles as tpp
from flipviscosity3d_torch.ops.particle_grid import liquid_sdf_from_particles
from flipviscosity3d_torch.solvers import pressure as tps
from flipviscosity3d_torch.solvers import viscosity as tvs

DT = 0.01
CLOSE = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    sim = FluidSimulation("cpu")
    sim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16)
    sim.add_liquid(box_mesh((0.2, 0.2, 0.2), (0.8, 0.55, 0.8)))
    sim.set_viscosity(2.0)
    cfg, st = sim.cfg, sim.state
    stream = tpp.tiled_sort(st.pos, st.vel, cfg.dx, cfg.grid_shape)
    _, table = tpp.scatter_p2g_table(stream.pos, stream.vel, stream.key,
                                     stream.rank, cfg.grid_shape, cfg.dx, 16)
    phi = liquid_sdf_from_particles(
        tpp.table_fields(table, 16), cfg.grid_shape, cfg.dx,
        cfg.particle_radius, st.solid.center_phi)
    rng = np.random.default_rng(0)
    uvw = [rng.normal(scale=0.3, size=s).astype(np.float32)
           for s in (cfg.u_shape, cfg.v_shape, cfg.w_shape)]
    jcfg = JaxConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                     bucket_capacity=16)
    return cfg, jcfg, st, phi, uvw


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pressure_system_solve_and_apply_match_jax(scene):
    cfg, jcfg, st, phi, uvw = scene
    sd = st.solid
    weights = (sd.weight_u, sd.weight_v, sd.weight_w)
    jsys = jax.jit(lambda *a: jps.build_pressure_system(*a, DT, jcfg))(
        *map(_j, uvw), _j(phi), *map(_j, weights))
    tsys = tps.build_pressure_system(*map(_t, uvw), phi, *weights, DT, cfg)
    np.testing.assert_array_equal(tsys.fluid.numpy(), np.asarray(jsys.fluid))
    for name in ("diag", "plus_i", "plus_j", "plus_k", "b", "theta_u",
                 "theta_v", "theta_w"):
        np.testing.assert_allclose(getattr(tsys, name).numpy(),
                                   np.asarray(getattr(jsys, name)),
                                   err_msg=name, **CLOSE)

    jres = jax.jit(lambda s: jps.solve_pressure(s, jcfg))(jsys)
    tres = tps.solve_pressure(tsys, cfg)
    assert tres.iterations == int(jres.iterations) > 0
    assert tres.converged and bool(jres.converged)
    jx = np.asarray(jres.x)
    np.testing.assert_allclose(tres.x[0].numpy(), jx, rtol=0,
                               atol=1e-5 * np.abs(jx).max())

    jout = jax.jit(lambda *a: jps.apply_pressure(*a, DT, jcfg))(
        *map(_j, uvw), jres.x, _j(phi), *map(_j, weights))
    tout = tps.apply_pressure(*map(_t, uvw), _t(jx), phi, *weights, DT, cfg)
    for j, t in zip(jout[:3], tout[:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    for j, t in zip(jout[3:], tout[3:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_viscosity_system_solve_and_apply_match_jax(scene):
    cfg, jcfg, st, phi, uvw = scene
    sd = st.solid
    jvol = jax.jit(lambda p: jvs.compute_volume_grids(p, jcfg))(_j(phi))
    tvol = tvs.compute_volume_grids(phi, cfg)
    for name in ("center", "u", "v", "w", "edge_u", "edge_v", "edge_w"):
        np.testing.assert_allclose(getattr(tvol, name).numpy(),
                                   np.asarray(getattr(jvol, name)),
                                   err_msg=name, **CLOSE)
    jstates = jvs.compute_face_states(_j(sd.center_phi), jcfg)
    tstates = tvs.compute_face_states(sd.center_phi, cfg)
    for j, t in zip(jstates, (tstates.solid_u, tstates.solid_v,
                              tstates.solid_w)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    visc = st.viscosity
    jsys = jax.jit(lambda *a: jvs.build_viscosity_system(*a, DT, jcfg))(
        *map(_j, uvw), jvol, jstates, _j(visc))
    tsys = tvs.build_viscosity_system(*map(_t, uvw), tvol, tstates, visc,
                                      DT, cfg)
    for c in range(3):
        np.testing.assert_array_equal(tsys.in_mat[c].numpy(),
                                      np.asarray(jsys.in_mat[c]))
        np.testing.assert_allclose(tsys.diag[c].numpy(),
                                   np.asarray(jsys.diag[c]), **CLOSE)
        np.testing.assert_allclose(tsys.rhs[c].numpy(),
                                   np.asarray(jsys.rhs[c]), rtol=1e-6,
                                   atol=1e-6)

    jres = jax.jit(lambda s, w: jvs.solve_viscosity(s, jcfg, warm_start=w))(
        jsys, tuple(map(_j, uvw)))
    tres = tvs.solve_viscosity(tsys, cfg, warm_start=tuple(map(_t, uvw)))
    assert tres.iterations == int(jres.iterations) > 0
    for j, t in zip(jres.x, tres.x):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())

    jout = jvs.apply_viscosity_solution(*map(_j, uvw), jsys, jres, jcfg)
    tout = tvs.apply_viscosity_solution(*map(_t, uvw), tsys, tres, cfg)
    for j, t in zip(jout, tout):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())
