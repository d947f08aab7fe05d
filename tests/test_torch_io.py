"""The port's mesh I/O, primitives, interpolation, vector math, bounding
boxes, debug checks and checkpoints against the JAX package, on the CPU.

Inputs are made with numpy from a seed. Mesh files are written from
io/primitives meshes into pytest's tmp_path; nothing reads sample meshes from
outside the repository. Tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.core.state import SimState as JaxState
from flipviscosity3d_tpu.core.state import SolidBoundary as JaxSolid
from flipviscosity3d_tpu.io import primitives as jprim
from flipviscosity3d_tpu.io import trianglemesh as jtm
from flipviscosity3d_tpu.ops import grids as jgrids
from flipviscosity3d_tpu.ops import interp as jinterp
from flipviscosity3d_tpu.utils import aabb as jaabb
from flipviscosity3d_tpu.utils import checkpoint as jckpt
from flipviscosity3d_tpu.utils import vmath as jvm
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.sim import FluidSimulation
from flipviscosity3d_torch.core.state import state_to_numpy
from flipviscosity3d_torch.io import primitives as tprim
from flipviscosity3d_torch.io import trianglemesh as ttm
from flipviscosity3d_torch.ops import grids as tgrids
from flipviscosity3d_torch.ops import interp as tinterp
from flipviscosity3d_torch.utils import aabb as taabb
from flipviscosity3d_torch.utils import checkpoint as tckpt
from flipviscosity3d_torch.utils import debug as tdebug
from flipviscosity3d_torch.utils import vmath as tvm

PRIMITIVES = {
    "sphere": ((0.5, 0.5, 0.5), 0.3, 2),
    "cube": ((0.4, 0.5, 0.6), 0.5),
    "rod": ((0.5, 0.5, 0.5), 0.1, 0.6, 2, 12),
    "sheet": ((0.5, 0.3, 0.5), 0.6, 0.4, 0.05, 1),
    "cone": ((0.5, 0.2, 0.5), 0.2, 0.5, 1, 16),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitives_equal_jax(name):
    j = getattr(jprim, name)(*PRIMITIVES[name])
    t = getattr(tprim, name)(*PRIMITIVES[name])
    assert t.vertices.dtype == np.float32 and t.triangles.dtype == np.int32
    np.testing.assert_array_equal(t.vertices, j.vertices)
    np.testing.assert_array_equal(t.triangles, j.triangles)


def _ascii_ply(path, mesh):
    """An ASCII PLY with quad-free faces (neither package writes ASCII)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(mesh.vertices)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(mesh.triangles)}\n"
                "property list uchar int vertex_index\nend_header\n")
        for v in mesh.vertices:
            f.write(" ".join(repr(float(c)) for c in v) + "\n")
        for t in mesh.triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def _save(pkg, fmt, path, mesh, colors):
    if fmt == "ply":
        pkg.save_ply(path, mesh)
    elif fmt == "ply_colors":
        pkg.save_ply(path, mesh, vertex_colors=colors)
    elif fmt == "ply_ascii":
        _ascii_ply(path, mesh)
    elif fmt == "obj":
        pkg.save_obj(path, mesh)
    else:
        pkg.save_bobj(path, mesh)


def _load(pkg, fmt, path):
    return {"obj": pkg.load_obj, "bobj": pkg.load_bobj}.get(
        fmt, pkg.load_ply)(path)


@pytest.mark.parametrize("fmt", ["ply", "ply_colors", "ply_ascii", "obj",
                                 "bobj"])
@pytest.mark.parametrize("name", ["sphere", "rod"])
def test_mesh_files_cross_the_two_packages(fmt, name, tmp_path):
    """A file written by the port is read by the JAX package's reader and
    the other way round: vertices and triangles equal (OBJ prints each
    float32 at its shortest round-trip precision, so it is exact too), and
    the two writers' files are byte for byte the same."""
    mesh = getattr(tprim, name)(*PRIMITIVES[name])
    colors = np.random.default_rng(3).integers(
        0, 256, size=(len(mesh.vertices), 3), dtype=np.uint8)
    jmesh = jtm.TriangleMesh(mesh.vertices, mesh.triangles)
    by_port, by_jax = str(tmp_path / "port.mesh"), str(tmp_path / "jax.mesh")
    _save(ttm, fmt, by_port, mesh, colors)
    _save(jtm, fmt, by_jax, jmesh, colors)
    with open(by_port, "rb") as a, open(by_jax, "rb") as b:
        assert a.read() == b.read()
    for got in (_load(jtm, fmt, by_port), _load(ttm, fmt, by_jax),
                _load(ttm, fmt, by_port)):
        np.testing.assert_array_equal(got.vertices, mesh.vertices)
        np.testing.assert_array_equal(got.triangles, mesh.triangles)
        assert got.vertices.dtype == np.float32
        assert got.triangles.dtype == np.int32


def test_mesh_readers_take_what_the_jax_readers_take(tmp_path):
    """Quads are fan-triangulated (ASCII PLY and OBJ), OBJ takes the v/vt/vn
    index forms and negative indices, a file without end_header is refused,
    and translate / aabb act as in JAX."""
    ply = tmp_path / "quad.ply"
    ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
        "property float y\nproperty float z\nelement face 1\n"
        "property list uchar int vertex_index\nend_header\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                   "f 1/1/1 2//2 3/3 -1\n")
    for path, name in ((ply, "load_ply"), (obj, "load_obj")):
        t, j = getattr(ttm, name)(str(path)), getattr(jtm, name)(str(path))
        np.testing.assert_array_equal(t.triangles, [[0, 1, 2], [0, 2, 3]])
        np.testing.assert_array_equal(t.triangles, j.triangles)
        np.testing.assert_array_equal(t.vertices, j.vertices)
    bad = tmp_path / "bad.ply"
    bad.write_text("ply\nformat ascii 1.0\n")
    with pytest.raises(ValueError, match="end_header"):
        ttm.load_ply(str(bad))
    t = tprim.cube((0.5, 0.5, 0.5), 0.4).translate((0.1, 0.0, -0.1))
    j = jprim.cube((0.5, 0.5, 0.5), 0.4).translate((0.1, 0.0, -0.1))
    np.testing.assert_array_equal(t.vertices, j.vertices)
    for a, b in zip(t.aabb(), j.aabb()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# interpolation, shifted_add
# ---------------------------------------------------------------------------

GRID_SHAPE = (8, 6, 7)
IDX = 1.0 / 8


def _interp_inputs():
    """Node, cell and MAC grids and positions, some of them outside the
    domain and on its faces."""
    rng = np.random.default_rng(21)
    ni, nj, nk = GRID_SHAPE
    grids = {
        "node": rng.normal(size=(ni + 1, nj + 1, nk + 1)),
        "cell": rng.normal(size=GRID_SHAPE),
        "u": rng.normal(size=(ni + 1, nj, nk)),
        "v": rng.normal(size=(ni, nj + 1, nk)),
        "w": rng.normal(size=(ni, nj, nk + 1)),
    }
    ext = np.array(GRID_SHAPE) * IDX
    pos = rng.random((400, 3)) * (ext + 4 * IDX) - 2 * IDX
    pos[:6] = [[0, 0, 0], ext, [0.5, 0, 0.3], [ext[0], 0.2, 0.2],
               [0.25, 0.25, 0.25], [-IDX, 0.1, 0.1]]
    return ({k: g.astype(np.float32) for k, g in grids.items()},
            pos.astype(np.float32))


INTERP_CASES = {
    "trilinear": lambda m, g, p: m.trilinear(g["node"], p, IDX),
    "trilinear_gradient":
        lambda m, g, p: m.trilinear_gradient(g["node"], p, IDX),
    "sample_liquid_phi":
        lambda m, g, p: m.sample_liquid_phi(g["cell"], p, IDX),
    "sample_solid_phi":
        lambda m, g, p: m.sample_solid_phi(g["node"], p, IDX),
    "sample_solid_phi_gradient":
        lambda m, g, p: m.sample_solid_phi_gradient(g["node"], p, IDX),
    "in_grid": lambda m, g, p: m.in_grid(p, IDX, GRID_SHAPE),
    "sample_mac_component":
        lambda m, g, p: m.sample_mac_component(g["v"], p, IDX, GRID_SHAPE,
                                               "v"),
    "sample_mac_linear":
        lambda m, g, p: m.sample_mac_linear(g["u"], g["v"], g["w"], p, IDX,
                                            GRID_SHAPE),
    "tricubic": lambda m, g, p: m.tricubic(g["node"], p, IDX),
    "sample_mac_cubic":
        lambda m, g, p: m.sample_mac_cubic(g["u"], g["v"], g["w"], p, IDX,
                                           GRID_SHAPE),
}


@pytest.mark.parametrize("name", sorted(INTERP_CASES))
def test_interp_matches_jax(name):
    """f32 on both sides, the same arithmetic: rtol 1e-6 with atol 1e-6 for
    the trilinear family (sums of 8 products of O(1) values), 1e-5 for the
    tricubic ones (64 points through three nested cubics); in_grid
    exactly."""
    grids, pos = _interp_inputs()
    j = np.asarray(INTERP_CASES[name](
        jinterp, {k: jnp.asarray(g) for k, g in grids.items()},
        jnp.asarray(pos)))
    t = INTERP_CASES[name](
        tinterp, {k: torch.from_numpy(g) for k, g in grids.items()},
        torch.from_numpy(pos)).numpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    if name == "in_grid":
        np.testing.assert_array_equal(t, j)
        assert t.any() and not t.all()
    else:
        tol = 1e-5 if "cubic" in name else 1e-6
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol)
        assert np.abs(j).max() > 0.1


@pytest.mark.parametrize("offset", [(0, 0, 0), (1, 0, 0), (-1, 2, 0),
                                    (0, -1, 1), (3, -3, 2), (9, 0, 0)])
def test_shifted_add_matches_jax(offset):
    """target[c + offset] += values[c], a (5,6,7) block into a (6,6,8)
    target, overlaps partial and empty: exact (one addition per element),
    the target itself untouched."""
    rng = np.random.default_rng(8)
    target = rng.normal(size=(6, 6, 8)).astype(np.float32)
    values = rng.normal(size=(5, 6, 7)).astype(np.float32)
    j = np.asarray(jgrids.shifted_add(jnp.asarray(target),
                                      jnp.asarray(values), offset))
    tt = torch.from_numpy(target.copy())
    t = tgrids.shifted_add(tt, torch.from_numpy(values), offset)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(tt.numpy(), target)


# ---------------------------------------------------------------------------
# vmath, aabb, debug
# ---------------------------------------------------------------------------

def _vm_inputs():
    rng = np.random.default_rng(17)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {"a": f(5, 3), "b": f(5, 3), "m1": f(5, 3, 3), "m2": f(5, 3, 3),
            "q1": f(5, 4), "q2": f(5, 4),
            "rads": rng.random(5).astype(np.float32) * 3.0}


VMATH_CASES = {
    "dot": lambda m, x: m.dot(x["a"], x["b"]),
    "cross": lambda m, x: m.cross(x["a"], x["b"]),
    "lengthsq": lambda m, x: m.lengthsq(x["a"]),
    "length": lambda m, x: m.length(x["a"]),
    "normalize": lambda m, x: m.normalize(x["a"]),
    "normalize_eps": lambda m, x: m.normalize(x["a"] * 0, eps=1e-3),
    "equals": lambda m, x: m.equals(x["a"], x["a"] + 0.5 * (x["b"] > 1),
                                    0.25),
    "mat3_identity": lambda m, x: m.mat3_identity(),
    "mat3_mult": lambda m, x: m.mat3_mult(x["m1"], x["m2"]),
    "mat3_vec": lambda m, x: m.mat3_vec(x["m1"], x["a"]),
    "transpose": lambda m, x: m.transpose(x["m1"]),
    "mat3_det": lambda m, x: m.mat3_det(x["m1"]),
    "mat3_inverse": lambda m, x: m.mat3_inverse(
        x["m1"] + 4 * m.mat3_identity()),
    "quat_identity": lambda m, x: m.quat_identity(),
    "quat_from_axis_angle":
        lambda m, x: m.quat_from_axis_angle(x["rads"], x["a"]),
    "quat_normalize": lambda m, x: m.quat_normalize(x["q1"]),
    "quat_mult": lambda m, x: m.quat_mult(x["q1"], x["q2"]),
    "quat_to_mat3": lambda m, x: m.quat_to_mat3(m.quat_normalize(x["q1"])),
    "quat_rotate": lambda m, x: m.quat_rotate(m.quat_normalize(x["q1"]),
                                              x["a"]),
}


@pytest.mark.parametrize("name", sorted(VMATH_CASES))
def test_vmath_matches_jax(name):
    """f32, rtol 1e-6 with atol 1e-6 (det and inverse go through LAPACK on
    one side and XLA on the other: 1e-5)."""
    x = _vm_inputs()
    j = np.asarray(VMATH_CASES[name](
        jvm, {k: jnp.asarray(v) for k, v in x.items()}))
    t = VMATH_CASES[name](
        tvm, {k: torch.from_numpy(v) for k, v in x.items()}).numpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    tol = 1e-5 if name in ("mat3_det", "mat3_inverse") else 1e-6
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


AABB_CASES = {
    "extents": lambda b, p: b.extents,
    "min_max": lambda b, p: np.stack([b.get_min_point(), b.get_max_point()]),
    "expand": lambda b, p: b.expand(-0.1).get_max_point(),
    "is_point_inside": lambda b, p: b.is_point_inside(p),
    "nearest_point_inside": lambda b, p: b.nearest_point_inside(p),
    "is_line_intersecting": lambda b, p: np.array(
        [b.is_line_intersecting(p[i], p[i + 1]) for i in range(40)]),
}


@pytest.mark.parametrize("name", sorted(AABB_CASES))
def test_aabb_matches_jax(name):
    rng = np.random.default_rng(4)
    pts = rng.random((60, 3)) * 2.0 - 0.5
    boxes = [m.AABB.from_points(rng.random((9, 3)))
             for m, rng in ((taabb, np.random.default_rng(5)),
                            (jaabb, np.random.default_rng(5)))]
    t, j = (AABB_CASES[name](b, pts) for b in boxes)
    np.testing.assert_array_equal(t, j)
    t2 = AABB_CASES[name](taabb.AABB.from_extents(0.1, 0.2, 0.3, 0.5, 0.4,
                                                  0.6), pts)
    j2 = AABB_CASES[name](jaabb.AABB.from_extents(0.1, 0.2, 0.3, 0.5, 0.4,
                                                  0.6), pts)
    np.testing.assert_array_equal(t2, j2)


# ---------------------------------------------------------------------------
# checkpoint, validate_state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim():
    torch.set_num_threads(1)
    s = FluidSimulation("cpu")
    s.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16)
    s.add_boundary(tprim.cube((0.5, 0.2, 0.5), 0.15))
    s.add_liquid(tprim.sphere((0.5, 0.6, 0.5), 0.2))
    s.set_viscosity(2.0)
    s.advance(0.01)
    return s


def _jax_state(arrays):
    solid = JaxSolid(**{k: jnp.asarray(arrays[k]) for k in JaxSolid._fields})
    return JaxState(solid=solid, **{
        k: jnp.asarray(arrays[k]) for k in JaxState._fields if k != "solid"})


def _jax_leaves(state):
    out = {k: np.asarray(v) for k, v in state._asdict().items()
           if k != "solid"}
    out.update({k: np.asarray(v) for k, v in state.solid._asdict().items()})
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_the_two_packages(writer, sim, tmp_path):
    """JAX save_state -> port load_state -> state_to_numpy equals the JAX
    state leaf for leaf, dtypes included; port save_state -> JAX load_state
    the same; and both writers use the same keys (dotted paths, `solid.`
    for the boundary)."""
    arrays = state_to_numpy(sim.state)
    jstate = _jax_state(arrays)
    path = str(tmp_path / "ckpt.npz")
    if writer == "jax":
        jckpt.save_state(path, jstate)
        got = state_to_numpy(tckpt.load_state(path, "cpu"))
    else:
        tckpt.save_state(path, sim.state)
        got = _jax_leaves(jckpt.load_state(path))
    want = _jax_leaves(jstate)
    assert set(got) == set(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    with np.load(path) as data:
        assert set(data.files) == set(jckpt._flatten(jstate))
        assert "solid.phi" in data.files and "pos" in data.files


def test_resume_advances_as_the_live_state(sim, tmp_path):
    """save -> load -> advance equals advancing the live state: torch.equal
    on the CPU, diagnostics included."""
    path = str(tmp_path / "resume.npz")
    tckpt.save_state(path, sim.state)
    live, dlive = tstep.advance(sim.state, 0.01, sim.cfg)
    back, dback = tstep.advance(tckpt.load_state(path, "cpu"), 0.01, sim.cfg)
    for k in ("pos", "vel", "u", "v", "w"):
        assert torch.equal(getattr(live, k), getattr(back, k)), k
    assert dlive.as_dict() == dback.as_dict()


def test_validate_state_names_what_is_wrong(sim):
    """As the JAX package's validate_state: healthy -> no problems; each
    fault -> its message."""
    assert tdebug.validate_state(sim.state, sim.cfg) == []
    pos = sim.state.pos.clone()
    pos[0, 0] = float("nan")
    pos[1, 1] = 1.5
    vel = sim.state.vel.clone()
    vel[2, 2] = float("inf")
    u = sim.state.u.clone()
    u[3, 3, 3] = float("nan")
    bad = sim.state.replace(pos=pos, vel=vel, u=u)
    assert tdebug.validate_state(bad, sim.cfg) == [
        "non-finite particle positions", "non-finite particle velocities",
        "particles outside the domain box", "non-finite u velocity grid"]
    tdebug.enable_debug(True)
    assert torch.is_anomaly_enabled()
    tdebug.enable_debug(False)
    assert not torch.is_anomaly_enabled()
