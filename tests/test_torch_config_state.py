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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX fields with no counterpart in the port: the TPU engine variants and
# their knobs (the port implements one variant of each, config.py).
TPU_ONLY = {
    "particle_engine", "pallas_pass_a", "pallas_pass_b", "pallas_pushback",
    "pallas_midpoint_budget", "pallas_midpoint_factor", "pallas_resort_every",
    "pallas_passa_budget", "pallas_passa_factor", "pallas_split_gather",
    "pallas_gather_dtype", "pallas_split_terms", "mg_backend",
}
SEED_BOX = ((0.2, 0.2, 0.2), (0.8, 0.55, 0.8))
OBSTACLE = ((0.45, 0.1, 0.4), (0.6, 0.3, 0.55))


def test_config_shared_fields_match_jax_defaults():
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(SimConfig)}
    assert port_fields == jax_fields - TPU_ONLY
    jc, pc = JaxConfig(), SimConfig()
    for name in sorted(port_fields):
        assert getattr(pc, name) == getattr(jc, name), name
    for prop in ("grid_shape", "n_cells", "particle_radius", "u_shape",
                 "v_shape", "w_shape", "node_shape"):
        assert getattr(pc, prop) == getattr(jc, prop), prop


@pytest.mark.parametrize("field", [
    "on_bucket_overflow", "mg_operator_dtype", "viscosity_preconditioner",
    "pressure_preconditioner"])
def test_config_rejects_unknown_enum_values(field):
    with pytest.raises(ValueError):
        SimConfig(**{field: "nonsense"})


def test_package_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import flipviscosity3d_torch, flipviscosity3d_torch.smoke\n"
        "import flipviscosity3d_torch.core.step\n"
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
