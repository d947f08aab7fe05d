"""The PyTorch port's config, state bridge, scene setup and grid primitives
against the JAX package, on the CPU.

Inputs are made with numpy from a seed; tolerances are stated per test.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.core.sim import FluidSimulation as JaxSim
from flipviscosity3d_tpu.core.state import SimState as JaxState
from flipviscosity3d_tpu.core.state import SolidBoundary as JaxSolid
from flipviscosity3d_tpu.io.trianglemesh import box_mesh as jax_box_mesh
from flipviscosity3d_tpu.ops import extrapolate as jex
from flipviscosity3d_tpu.ops import levelset as jls
from flipviscosity3d_tpu.ops import mesh_sdf as jmesh
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.core.sim import FluidSimulation
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.io.trianglemesh import box_mesh
from flipviscosity3d_torch.ops import extrapolate as tex
from flipviscosity3d_torch.ops import levelset as tls
from flipviscosity3d_torch.ops import mesh_sdf as tmesh
from flipviscosity3d_torch.ops.pallas_particles import split_round

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX fields with no counterpart in the port: none (pallas_split_terms and
# mg_backend are taken, config.py).
TPU_ONLY = set()
# Shared fields whose default differs between the packages: none.
OWN_DEFAULT = set()
SEED_BOX = ((0.2, 0.2, 0.2), (0.8, 0.55, 0.8))
OBSTACLE = ((0.45, 0.1, 0.4), (0.6, 0.3, 0.55))


def test_config_shared_fields_match_jax_defaults():
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(SimConfig)}
    assert port_fields == jax_fields - TPU_ONLY
    jc, pc = JaxConfig(), SimConfig()
    for name in sorted(port_fields - OWN_DEFAULT):
        assert getattr(pc, name) == getattr(jc, name), name
    assert (pc.particle_engine, jc.particle_engine) == ("table", "table")
    assert pc.pallas_split_gather is None
    for prop in ("grid_shape", "n_cells", "particle_radius", "u_shape",
                 "v_shape", "w_shape", "node_shape"):
        assert getattr(pc, prop) == getattr(jc, prop), prop


@pytest.mark.parametrize("field", [
    "on_bucket_overflow", "mg_operator_dtype", "viscosity_preconditioner",
    "pressure_preconditioner", "pallas_pass_a", "pallas_pass_b",
    "pallas_pushback", "pallas_gather_dtype", "mg_backend"])
def test_config_rejects_unknown_enum_values(field):
    with pytest.raises(ValueError):
        SimConfig(**{field: "nonsense"})


@pytest.mark.parametrize("field", [
    "pallas_pass_a", "pallas_pass_b", "pallas_pushback",
    "pallas_gather_dtype"])
def test_config_variant_values_match_jax(field):
    """Each visit-plan switch takes JAX's values, and JAX takes the port's
    (the JAX config reaches none of them unless valid in its engine)."""
    from flipviscosity3d_torch.config import _ENUMS
    for value in _ENUMS[field]:
        assert getattr(SimConfig(**{field: value}), field) == value
        assert getattr(JaxConfig(**{field: value}), field) == value


@pytest.mark.parametrize("engine", ["table", "stream", "pallas"])
def test_config_takes_every_jax_engine_and_runs_it(engine):
    """A scene file's config block serves both CLIs: the port takes each of
    the JAX package's engines, and a FluidSimulation initialized with it
    advances a frame on it (16^3, CPU): the pool's cells fill, both solves
    iterate, and at a capacity of 2 the table and pallas engines count the
    particles they leave out, the stream engine (no capacity) none; under
    on_bucket_overflow="error" the next frame raises where it overflows.
    Any other name raises."""
    assert SimConfig(particle_engine=engine).particle_engine == engine
    assert JaxConfig(particle_engine=engine).particle_engine == engine
    with pytest.raises(ValueError, match="must be one of"):
        SimConfig(particle_engine="nonsense")
    torch.set_num_threads(1)
    sim = FluidSimulation("cpu")
    sim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=2,
                   particle_engine=engine)
    sim.add_liquid(box_mesh(*SEED_BOX))
    sim.set_viscosity(2.0)
    assert sim.cfg.particle_engine == engine
    diag = sim.advance(0.01)
    assert diag.substeps == 1 and diag.liquid_cells > 0
    assert diag.pressure_iterations > 0 and diag.viscosity_iterations > 0
    assert (diag.bucket_overflow > 0) == (engine != "stream")
    assert np.isfinite(sim.particle_positions).all()
    sim.cfg = dataclasses.replace(sim.cfg, on_bucket_overflow="error")
    if engine == "stream":
        assert sim.advance(0.01).bucket_overflow == 0
    else:
        with pytest.raises(RuntimeError, match="bucket overflow"):
            sim.advance(0.01)


@pytest.mark.parametrize("value", [None, True, False])
def test_config_takes_pallas_split_gather(value):
    assert SimConfig(pallas_split_gather=value).pallas_split_gather is value
    assert JaxConfig(pallas_split_gather=value).pallas_split_gather is value


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_config_takes_every_jax_mg_backend(backend):
    assert SimConfig(mg_backend=backend).mg_backend == backend
    assert JaxConfig(mg_backend=backend).mg_backend == backend


@pytest.mark.parametrize("terms", [1, 2, 3, 4])
def test_config_takes_split_terms_from_three(terms):
    """pallas_split_terms takes every int, as the JAX config does. 1 and 2
    round what the particle kernels multiply to bf16 terms as the JAX
    package's split products do (1: bf16(x); 2: bf16(x) plus bf16 of the
    rest); 3 and up keep the exact f32 products, what the JAX package
    computes at >= 3 off the TPU."""
    assert JaxConfig(pallas_split_terms=terms).pallas_split_terms == terms
    cfg = SimConfig(pallas_split_terms=terms)
    assert cfg.pallas_split_terms == terms
    x = torch.tensor([1.0 + 2.0 ** -20, 0.1, -3.3, 0.0])
    rounded = split_round(x, cfg.pallas_split_terms)
    if terms >= 3:
        assert torch.equal(rounded, x)
    else:
        one = x.to(torch.bfloat16).float()
        want = one if terms == 1 else one + (x - one).to(
            torch.bfloat16).float()
        assert torch.equal(rounded, want)
        assert not torch.equal(rounded, x)


def test_fluid_simulation_defaults_to_the_card():
    """FluidSimulation() places its state on the card; where torch sees no
    card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert FluidSimulation().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FluidSimulation()
    assert FluidSimulation("cpu").device.type == "cpu"


def test_package_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import flipviscosity3d_torch, flipviscosity3d_torch.smoke\n"
        "import flipviscosity3d_torch.core.step\n"
        "import flipviscosity3d_torch.cli\n"
        "import flipviscosity3d_torch.io.primitives\n"
        "import flipviscosity3d_torch.io.trianglemesh\n"
        "import flipviscosity3d_torch.ops.interp\n"
        "import flipviscosity3d_torch.utils.aabb\n"
        "import flipviscosity3d_torch.utils.checkpoint\n"
        "import flipviscosity3d_torch.utils.debug\n"
        "import flipviscosity3d_torch.utils.vmath\n"
        "import flipviscosity3d_torch.ops.buckets\n"
        "import flipviscosity3d_torch.ops.particle_grid\n"
        "import flipviscosity3d_torch.ops.stream\n"
        "import flipviscosity3d_torch.ops.stream_transfers\n"
        "import flipviscosity3d_torch.scripts.pallas_particle_proto\n"
        "assert not any(m.startswith('flipviscosity3d_tpu') "
        "for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.fixture(scope="module")
def scenes():
    """The same 16^3 scene set up by both packages."""
    torch.set_num_threads(1)
    jsim = JaxSim()
    jsim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16)
    jsim.add_boundary(jax_box_mesh(*OBSTACLE))
    jsim.add_liquid(jax_box_mesh(*SEED_BOX))
    jsim.set_viscosity(2.0)
    tsim = FluidSimulation("cpu")
    tsim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16)
    tsim.add_boundary(box_mesh(*OBSTACLE))
    tsim.add_liquid(box_mesh(*SEED_BOX))
    tsim.set_viscosity(2.0)
    return jsim, tsim


def _jax_arrays(state):
    out = {k: np.asarray(v) for k, v in state._asdict().items()
           if k != "solid"}
    out.update({k: np.asarray(v) for k, v in state.solid._asdict().items()})
    return out


def test_state_bridge_round_trips_the_jax_state(scenes):
    jsim, _ = scenes
    arrays = _jax_arrays(jsim.state)
    assert set(arrays) == (set(JaxState._fields) - {"solid"}) | set(
        JaxSolid._fields)
    back = state_to_numpy(state_from_numpy(arrays, "cpu"))
    assert set(back) == set(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_scene_setup_matches_jax(scenes):
    """Solid boundary (domain box united with an obstacle) from the mesh
    SDF: node phi to 1e-6 (the distance sums run in another order), derived
    face weights and states to 1e-5 / exactly. Seeding draws other random
    numbers, so only the particle count is held, to 2%, and every particle
    lies inside the seed box and none deep inside the obstacle."""
    jsim, tsim = scenes
    ja, ta = _jax_arrays(jsim.state), state_to_numpy(tsim.state)
    np.testing.assert_allclose(ta["phi"], ja["phi"], rtol=0, atol=1e-6)
    for k in ("center_phi", "weight_u", "weight_v", "weight_w"):
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in ("solid_u", "solid_v", "solid_w", "viscosity", "gravity"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    n_j, n_t = ja["pos"].shape[0], ta["pos"].shape[0]
    assert abs(n_t - n_j) <= 0.02 * n_j
    lo, hi = np.array(SEED_BOX[0]), np.array(SEED_BOX[1])
    assert ((ta["pos"] >= lo - 1e-6) & (ta["pos"] <= hi + 1e-6)).all()
    # the seeding test samples the node SDF trilinearly, which is inexact
    # within a cell of the obstacle's edges: hold the interior one cell in
    olo, ohi = np.array(OBSTACLE[0]) + 1 / 16, np.array(OBSTACLE[1]) - 1 / 16
    assert not ((ta["pos"] > olo) & (ta["pos"] < ohi)).all(axis=1).any()
    np.testing.assert_array_equal(tsim.particle_positions, ta["pos"])


def test_reset_boundary_drops_obstacles(scenes):
    """reset_boundary returns to the domain box alone, in both packages:
    node phi to 1e-6 of JAX's, and the obstacle's solid nodes are gone."""
    jsim, _ = scenes
    tsim = FluidSimulation("cpu")
    tsim.initialize(16, 16, 16, 1.0 / 16)
    bare = tsim.state.solid.phi.clone()
    tsim.add_boundary(box_mesh(*OBSTACLE))
    with_obstacle = tsim.state.solid.phi
    assert (with_obstacle < bare - 1e-3).any()
    tsim.reset_boundary()
    assert tsim._state is None
    assert torch.equal(tsim.state.solid.phi, bare)
    fresh = JaxSim()
    fresh.initialize(16, 16, 16, 1.0 / 16)
    fresh.add_boundary(jax_box_mesh(*OBSTACLE))
    fresh.reset_boundary()
    np.testing.assert_allclose(bare.numpy(),
                               np.asarray(fresh.state.solid.phi), rtol=0,
                               atol=1e-6)


def test_particle_velocities_reads_the_state(scenes):
    """Zero after seeding, as in JAX; after a frame, the state's."""
    jsim, tsim = scenes
    assert jsim.particle_velocities.shape == jsim.particle_positions.shape
    sim = FluidSimulation("cpu")
    sim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16)
    sim.add_liquid(box_mesh(*SEED_BOX))
    vel = sim.particle_velocities
    assert vel.shape == sim.particle_positions.shape and not vel.any()
    sim.advance(0.01)
    vel = sim.particle_velocities
    assert isinstance(vel, np.ndarray) and vel.dtype == np.float32
    np.testing.assert_array_equal(vel, sim.state.vel.numpy())
    assert np.abs(vel).max() > 0


def test_assigned_state_is_honoured_and_advanced_from(scenes):
    """The CLI resumes by assigning sim._state: the `state` property must
    hand that state back, and advance must run from it. Two sims of one
    scene, one advanced a frame; its state assigned to the other makes the
    other's next frame bit-equal to the first's."""
    def make():
        sim = FluidSimulation("cpu")
        sim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16)
        sim.add_liquid(box_mesh(*SEED_BOX))
        sim.set_viscosity(2.0)
        return sim

    a, b = make(), make()
    a.advance(0.01)
    b._state = a.state
    assert b.state is a.state
    np.testing.assert_array_equal(b.particle_positions, a.particle_positions)
    a.advance(0.01)
    b.advance(0.01)
    assert torch.equal(a.state.pos, b.state.pos)
    assert torch.equal(a.state.vel, b.state.vel)
    assert a.last_diagnostics.as_dict() == b.last_diagnostics.as_dict()


def test_mesh_to_sdf_matches_jax_off_grid():
    """A box whose faces fall between nodes, at a non-cubic grid: distances
    to 1e-6, signs exact."""
    verts = box_mesh((0.13, 0.21, 0.17), (0.71, 0.52, 0.66))
    shape, dx = (16, 12, 20), 1.0 / 20
    j = np.asarray(jmesh.mesh_to_sdf(verts.vertices, verts.triangles, shape,
                                     dx).phi)
    t = tmesh.mesh_to_sdf(verts.vertices, verts.triangles, shape, dx,
                          "cpu").phi.numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t < 0, j < 0)


def _phis(rng, n, shape=(6, 7, 5)):
    """Random corner samples with exact zeros and ties mixed in."""
    out = []
    for _ in range(n):
        a = rng.normal(size=shape).astype(np.float32)
        a[rng.random(shape) < 0.1] = 0.0
        out.append(a)
    tie = rng.random(shape) < 0.2
    out[-1][tie] = out[0][tie]
    return out


@pytest.mark.parametrize("name,n_args", [
    ("fraction_inside", 2), ("fraction_inside_quad", 4),
    ("volume_fraction_cube", 8)])
def test_levelset_fractions_match_jax(name, n_args):
    """Same arithmetic order on both sides; 1e-6 covers XLA's fused
    multiply-adds."""
    phis = _phis(np.random.default_rng(n_args), n_args)
    j = np.asarray(getattr(jls, name)(*(jnp.asarray(p) for p in phis)))
    t = getattr(tls, name)(*(torch.from_numpy(p) for p in phis)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_extrapolation_matches_jax():
    """Masked layer extrapolation: validity exact, values to 1e-6."""
    rng = np.random.default_rng(5)
    grid = rng.normal(size=(17, 16, 16)).astype(np.float32)
    valid = rng.random((17, 16, 16)) < 0.05
    grid = np.where(valid, grid, 0.0).astype(np.float32)
    jg, jv = jex.extrapolate_grid(jnp.asarray(grid), jnp.asarray(valid), 7)
    tg, tv = tex.extrapolate_grid(torch.from_numpy(grid),
                                  torch.from_numpy(valid), 7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
