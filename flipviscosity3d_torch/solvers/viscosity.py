"""Batty-Bridson variational viscosity solve, matrix-free and coupled.

Counterpart of flipviscosity3d_tpu/solvers/viscosity.py (reference
viscositysolver.cpp:41-727): face states, the 7 control-volume fraction
grids, the coupled U/V/W system with solid-Dirichlet velocities moved to the
RHS, PCG with a relative inf-norm tolerance, and the write-back. For CUDA
tensors the build (`compute_volume_grids`, `build_viscosity_system`)
launches the CUDA kernel K14 and the coupled operator (`viscosity_operator`)
K13; their plain versions (`compute_volume_grids_ref`,
`build_viscosity_system_ref`, `_apply_coupling`) are the CPU path.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..config import SimConfig
from ..ops.grids import shifted_read
from ..ops.levelset import volume_fraction_cube
from ..utils import trace
from .pcg import jacobi_preconditioner, pcg


@dataclasses.dataclass
class FaceStates:
    """True where the face is SOLID."""

    solid_u: torch.Tensor
    solid_v: torch.Tensor
    solid_w: torch.Tensor


def compute_face_states(solid_center_phi, cfg: SimConfig) -> FaceStates:
    """Solid on the grid edge (component axis) or where the two adjacent
    solid cell-center phis sum <= 0 (viscositysolver.cpp:80-123)."""
    p = solid_center_phi
    dev = p.device
    su = torch.ones(cfg.u_shape, dtype=torch.bool, device=dev)
    su[1:-1] = p[:-1] + p[1:] <= 0
    sv = torch.ones(cfg.v_shape, dtype=torch.bool, device=dev)
    sv[:, 1:-1] = p[:, :-1] + p[:, 1:] <= 0
    sw = torch.ones(cfg.w_shape, dtype=torch.bool, device=dev)
    sw[:, :, 1:-1] = p[:, :, :-1] + p[:, :, 1:] <= 0
    return FaceStates(su, sv, sw)


def _pad_axis(arr, axis, lo, hi):
    pad = [0, 0] * 3
    pad[2 * (2 - axis)] = lo
    pad[2 * (2 - axis) + 1] = hi
    return F.pad(arr, pad)


def _ext_axis(arr, axis):
    """corner[n] = arr[n], out of range -> 0; one longer."""
    return _pad_axis(arr, axis, 0, 1)


def _avg_axis(arr, axis):
    """corner[n] = 0.5*(arr[n-1] + arr[n]), out of range -> 0; two longer."""
    return 0.5 * (_pad_axis(arr, axis, 1, 1) + _pad_axis(arr, axis, 0, 2))


@dataclasses.dataclass
class VolumeGrids:
    center: torch.Tensor  # (I,J,K)
    u: torch.Tensor       # (I+1,J,K)
    v: torch.Tensor       # (I,J+1,K)
    w: torch.Tensor       # (I,J,K+1)
    edge_u: torch.Tensor  # (I,J+1,K+1)
    edge_v: torch.Tensor  # (I+1,J,K+1)
    edge_w: torch.Tensor  # (I+1,J+1,K)


def compute_volume_grids_ref(liquid_phi, cfg: SimConfig) -> VolumeGrids:
    """Plain version of compute_volume_grids: the 7 control-volume
    fraction grids (viscositysolver.cpp:135-270), restricted to the fluid
    mask dilated 2 layers over the (I+1,J+1,K+1) valid-cell grid. An axis
    with a half-cell centerStart samples corner phi at cell centers
    (identity), otherwise at midpoints (2-point average)."""
    isz, jsz, ksz = liquid_phi.shape
    valid = torch.zeros((isz + 1, jsz + 1, ksz + 1), dtype=torch.bool,
                        device=liquid_phi.device)
    valid[:isz, :jsz, :ksz] = liquid_phi < 0
    vshape = tuple(valid.shape)
    for _ in range(2):
        grown = valid
        for o in ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                  (0, 0, -1), (0, 0, 1)):
            grown = grown | shifted_read(valid, o, vshape, fill=False)
        valid = grown

    def volumes_for(half_axes):
        corner = liquid_phi
        for ax in range(3):
            corner = (_ext_axis(corner, ax) if half_axes[ax]
                      else _avg_axis(corner, ax))
        shape = tuple(corner.shape[a] - 1 for a in range(3))
        c = {}
        for bx in (0, 1):
            for by in (0, 1):
                for bz in (0, 1):
                    c[(bx, by, bz)] = corner[bx:bx + shape[0],
                                             by:by + shape[1],
                                             bz:bz + shape[2]]
        frac = volume_fraction_cube(
            c[0, 0, 0], c[1, 0, 0], c[0, 1, 0], c[1, 1, 0],
            c[0, 0, 1], c[1, 0, 1], c[0, 1, 1], c[1, 1, 1],
        )
        mask = valid[: shape[0], : shape[1], : shape[2]]
        return torch.where(mask, frac, torch.zeros_like(frac))

    return VolumeGrids(
        center=volumes_for((True, True, True)),
        u=volumes_for((False, True, True)),
        v=volumes_for((True, False, True)),
        w=volumes_for((True, True, False)),
        edge_u=volumes_for((True, False, False)),
        edge_v=volumes_for((False, True, False)),
        edge_w=volumes_for((False, False, True)),
    )


@dataclasses.dataclass
class ViscositySystem:
    in_mat: tuple       # (inU, inV, inW) bool row masks
    diag: tuple         # (diagU, diagV, diagW)
    vol: tuple          # (volU, volV, volW) diagonal mass terms
    factors: tuple      # per component: dict of 6 directional factor grids
    rhs: tuple          # (rhsU, rhsV, rhsW)


def _row_range_mask(shape, cfg, device):
    """Row index range [1, size) per axis on a face grid
    (viscositysolver.cpp:284-286, 381-383)."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[1:cfg.isize, 1:cfg.jsize, 1:cfg.ksize] = True
    return m


# Per component: (visc spec per direction, vol spec per direction,
# doubled directions). A visc spec is one node offset or four to average;
# a vol spec is (volume grid name, offset). viscositysolver.cpp:374-664.
_ROWS = (
    (
        {"r": [(0, 0, 0)], "l": [(-1, 0, 0)],
         "t": [(-1, 1, 0), (-1, 0, 0), (0, 1, 0), (0, 0, 0)],
         "b": [(-1, 0, 0), (-1, -1, 0), (0, 0, 0), (0, -1, 0)],
         "f": [(-1, 0, 1), (-1, 0, 0), (0, 0, 1), (0, 0, 0)],
         "k": [(-1, 0, 0), (-1, 0, -1), (0, 0, 0), (0, 0, -1)]},
        {"r": ("center", (0, 0, 0)), "l": ("center", (-1, 0, 0)),
         "t": ("edge_w", (0, 1, 0)), "b": ("edge_w", (0, 0, 0)),
         "f": ("edge_v", (0, 0, 1)), "k": ("edge_v", (0, 0, 0))},
        ("r", "l"), "u",
    ),
    (
        {"r": [(0, -1, 0), (1, -1, 0), (0, 0, 0), (1, 0, 0)],
         "l": [(0, -1, 0), (-1, -1, 0), (0, 0, 0), (-1, 0, 0)],
         "t": [(0, 0, 0)], "b": [(0, -1, 0)],
         "f": [(0, -1, 0), (0, -1, 1), (0, 0, 0), (0, 0, 1)],
         "k": [(0, -1, 0), (0, -1, -1), (0, 0, 0), (0, 0, -1)]},
        {"r": ("edge_w", (1, 0, 0)), "l": ("edge_w", (0, 0, 0)),
         "t": ("center", (0, 0, 0)), "b": ("center", (0, -1, 0)),
         "f": ("edge_u", (0, 0, 1)), "k": ("edge_u", (0, 0, 0))},
        ("t", "b"), "v",
    ),
    (
        {"r": [(0, 0, 0), (0, 0, -1), (1, 0, 0), (1, 0, -1)],
         "l": [(0, 0, 0), (0, 0, -1), (-1, 0, 0), (-1, 0, -1)],
         "t": [(0, 0, 0), (0, 0, -1), (0, 1, 0), (0, 1, -1)],
         "b": [(0, 0, 0), (0, 0, -1), (0, -1, 0), (0, -1, -1)],
         "f": [(0, 0, 0)], "k": [(0, 0, -1)]},
        {"r": ("edge_v", (1, 0, 0)), "l": ("edge_v", (0, 0, 0)),
         "t": ("edge_u", (0, 1, 0)), "b": ("edge_u", (0, 0, 0)),
         "f": ("center", (0, 0, 0)), "k": ("center", (0, 0, -1))},
        ("f", "k"), "w",
    ),
)


def build_viscosity_system_ref(u, v, w, volumes: VolumeGrids,
                               states: FaceStates, viscosity_node, dt,
                               cfg: SimConfig, row_masks=None
                               ) -> ViscositySystem:
    """Plain version of build_viscosity_system. `row_masks` (maskU, maskV,
    maskW) replaces the rows' index ranges ([1, size) per axis, the
    reference's assembly loop bounds); the slab pipeline passes its slabs'
    ranges in the GLOBAL domain."""
    factor = float(np.float32(dt) / np.float32(cfg.dx * cfg.dx))
    dev = u.device
    vels = (u, v, w)
    solids = (states.solid_u, states.solid_v, states.solid_w)
    factors, diags, vols, in_mat = [], [], [], []
    for comp, (visc_spec, vol_spec, doubled, own) in enumerate(_ROWS):
        shape = tuple(vels[comp].shape)
        fac = {}
        for key in ("r", "l", "t", "b", "f", "k"):
            offs = visc_spec[key]
            if len(offs) == 1:
                visc = shifted_read(viscosity_node, offs[0], shape)
            else:
                acc = 0
                for o in offs:
                    acc = acc + shifted_read(viscosity_node, o, shape)
                visc = 0.25 * acc
            grid, o = vol_spec[key]
            vol = shifted_read(getattr(volumes, grid), o, shape)
            if key in doubled:
                fac[key] = 2 * factor * visc * vol
            else:
                fac[key] = factor * visc * vol
        vol_face = shifted_read(getattr(volumes, own), (0, 0, 0), shape)
        diag = (vol_face + fac["r"] + fac["l"] + fac["t"] + fac["b"]
                + fac["f"] + fac["k"])
        any_vol = vol_face > 0
        for key in ("r", "l", "t", "b", "f", "k"):
            grid, o = vol_spec[key]
            any_vol = any_vol | (shifted_read(getattr(volumes, grid), o,
                                              shape) > 0)
        in_range = (_row_range_mask(shape, cfg, dev) if row_masks is None
                    else row_masks[comp])
        rows = in_range & ~solids[comp] & any_vol
        zero = torch.zeros(shape, dtype=torch.float32, device=dev)
        in_mat.append(rows)
        diags.append(torch.where(rows, diag, zero))
        factors.append({k: torch.where(rows, f, zero) for k, f in fac.items()})
        vols.append(vol_face)

    # RHS: vol*vel minus the coupling applied to solid-Dirichlet velocities
    dirichlet = tuple(vel * s.to(torch.float32)
                      for vel, s in zip(vels, solids))
    with trace.span("viscosity_operator"):
        cu, cv, cw = viscosity_operator(factors, dirichlet)
    rhs = tuple(
        torch.where(m, vol * vel - c, torch.zeros_like(vel))
        for m, vol, vel, c in zip(in_mat, vols, vels, (cu, cv, cw)))
    return ViscositySystem(tuple(in_mat), tuple(diags), tuple(vols),
                           tuple(factors), rhs)


def _apply_coupling(factors, xu, xv, xw):
    """Off-diagonal part of the coupled operator: the 14 neighbour couplings
    of each row (6 same-component + 8 cross-component), with the signs of
    viscositysolver.cpp:431-446, 529-544, 627-642."""
    fU, fV, fW = factors
    us, vs, ws = xu.shape, xv.shape, xw.shape

    def s(x, o, shape):
        return shifted_read(x, o, shape)

    yu = (
        -fU["r"] * s(xu, (1, 0, 0), us) - fU["l"] * s(xu, (-1, 0, 0), us)
        - fU["t"] * s(xu, (0, 1, 0), us) - fU["b"] * s(xu, (0, -1, 0), us)
        - fU["f"] * s(xu, (0, 0, 1), us) - fU["k"] * s(xu, (0, 0, -1), us)
        - fU["t"] * s(xv, (0, 1, 0), us) + fU["t"] * s(xv, (-1, 1, 0), us)
        + fU["b"] * s(xv, (0, 0, 0), us) - fU["b"] * s(xv, (-1, 0, 0), us)
        - fU["f"] * s(xw, (0, 0, 1), us) + fU["f"] * s(xw, (-1, 0, 1), us)
        + fU["k"] * s(xw, (0, 0, 0), us) - fU["k"] * s(xw, (-1, 0, 0), us)
    )
    yv = (
        -fV["r"] * s(xv, (1, 0, 0), vs) - fV["l"] * s(xv, (-1, 0, 0), vs)
        - fV["t"] * s(xv, (0, 1, 0), vs) - fV["b"] * s(xv, (0, -1, 0), vs)
        - fV["f"] * s(xv, (0, 0, 1), vs) - fV["k"] * s(xv, (0, 0, -1), vs)
        - fV["r"] * s(xu, (1, 0, 0), vs) + fV["r"] * s(xu, (1, -1, 0), vs)
        + fV["l"] * s(xu, (0, 0, 0), vs) - fV["l"] * s(xu, (0, -1, 0), vs)
        - fV["f"] * s(xw, (0, 0, 1), vs) + fV["f"] * s(xw, (0, -1, 1), vs)
        + fV["k"] * s(xw, (0, 0, 0), vs) - fV["k"] * s(xw, (0, -1, 0), vs)
    )
    yw = (
        -fW["r"] * s(xw, (1, 0, 0), ws) - fW["l"] * s(xw, (-1, 0, 0), ws)
        - fW["t"] * s(xw, (0, 1, 0), ws) - fW["b"] * s(xw, (0, -1, 0), ws)
        - fW["f"] * s(xw, (0, 0, 1), ws) - fW["k"] * s(xw, (0, 0, -1), ws)
        - fW["r"] * s(xu, (1, 0, 0), ws) + fW["r"] * s(xu, (1, 0, -1), ws)
        + fW["l"] * s(xu, (0, 0, 0), ws) - fW["l"] * s(xu, (0, 0, -1), ws)
        - fW["t"] * s(xv, (0, 1, 0), ws) + fW["t"] * s(xv, (0, 1, -1), ws)
        + fW["b"] * s(xv, (0, 0, 0), ws) - fW["b"] * s(xv, (0, 0, -1), ws)
    )
    return yu, yv, yw


# a component's factor grids, in the order K13 takes them
_KEYS = ("r", "l", "t", "b", "f", "k")


def viscosity_operator_ref(factors, x, diag=None):
    """Plain version of viscosity_operator: diag * x + C(x), C(x) by
    _apply_coupling; C(x) alone where `diag` is None."""
    c = _apply_coupling(factors, *x)
    if diag is None:
        return c
    return tuple(d * xi + ci for d, xi, ci in zip(diag, x, c))


# csrc/visc_operator.cu's column tile (TJ x TK, one thread each) and the
# blocks of 256 threads an SM holds at once (BLOCKS_PER_SM: 64 registers a
# thread)
_TILE_J, _TILE_K = 8, 32
_BLOCKS_PER_SM = 4
# waves of blocks a launch should give where its planes allow, so that the
# last, partly filled wave costs little
_WAVES = 8
# the fewest planes a block marches through: each block also loads x of the
# plane below its chunk and of the one above
_MIN_CHUNK = 4


def plane_chunk(shape, sms: int) -> int:
    """The planes each block of K13 marches through over the union domain
    `shape` (I, J, K) on a card of `sms` SMs: as many as still give _WAVES
    waves of blocks, and at least _MIN_CHUNK."""
    return _build.plane_chunk(shape, _TILE_J, _TILE_K, sms, _BLOCKS_PER_SM,
                              _WAVES, _MIN_CHUNK)


_ARGS = (ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
         _build.I, _build.P)


@_build.counted
def viscosity_operator(factors, x, diag=None):
    """K13, the coupled operator: (yu, yv, yw) = diag * x + C(x) on x = (xu,
    xv, xw), C the 14 couplings a row of _apply_coupling; C(x) alone where
    `diag` is None. `factors` holds a dict of _KEYS a component, premasked
    grids of that component's shape, as `diag` does. Takes the plain
    version for CPU tensors and launches the CUDA kernel
    (csrc/visc_operator.cu, bit-equal to it) for CUDA tensors; there is no
    fallback between the two."""
    if _build.on_cpu(x[0], "viscosity_operator"):
        return viscosity_operator_ref(factors, x, diag)
    ptrs, dims, y = [], [], []
    for c, (xc, fc) in enumerate(zip(x, factors)):
        _build.require(xc, f"x[{c}]", torch.float32, ndim=3)
        grids = {f"factors[{c}][{key!r}]": fc[key] for key in _KEYS}
        if diag is not None:
            grids[f"diag[{c}]"] = diag[c]
        for name, g in grids.items():
            _build.require(g, name, torch.float32, xc.shape)
        yc = torch.empty_like(xc)
        # x, the six factors, diag (null without it), y
        ptrs += [xc.data_ptr(), *(g.data_ptr() for g in grids.values()),
                 *([None] if diag is None else []), yc.data_ptr()]
        dims += xc.shape
        y.append(yc)
    union = tuple(max(dims[a::3]) for a in range(3))
    _build.launch("flip3d_visc_operator", _ARGS,
                  (ctypes.c_void_p * 27)(*ptrs), (ctypes.c_int * 9)(*dims),
                  plane_chunk(union, _build.sm_count(x[0])))
    _build.count(viscosity_operator)
    return tuple(y)


# VolumeGrids' fields, each with the axes on which its corner phi is the
# 2-point average (one cell longer than liquid_phi there), as
# compute_volume_grids_ref's half-cell axes leave them
_VOLUME_AXES = (("center", (0, 0, 0)), ("u", (1, 0, 0)), ("v", (0, 1, 0)),
                ("w", (0, 0, 1)), ("edge_u", (0, 1, 1)),
                ("edge_v", (1, 0, 1)), ("edge_w", (1, 1, 0)))
# torch divides a CUDA tensor by a Python scalar as a product with the
# scalar's f32 reciprocal: volume_fraction_cube's / 12.0
_INV12 = float(np.float32(1.0) / np.float32(12.0))
_VOLUME_ARGS = (_build.P, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                _build.I, _build.F, _build.P)


@_build.counted
def compute_volume_grids(liquid_phi, cfg: SimConfig) -> VolumeGrids:
    """The 7 control-volume fraction grids of compute_volume_grids_ref.
    Takes that plain version for CPU tensors and launches K14's volume
    kernel (csrc/visc_build.cu, bit-equal to it) for CUDA tensors, one
    launch for all 7; there is no fallback between the two."""
    _build.require(liquid_phi, "liquid_phi", torch.float32,
                   device=liquid_phi.device, ndim=3)
    if _build.on_cpu(liquid_phi, "compute_volume_grids"):
        return compute_volume_grids_ref(liquid_phi, cfg)
    shape = tuple(liquid_phi.shape)
    nodes = tuple(n + 1 for n in shape)
    if np.prod(nodes, dtype=np.int64) >= 1 << 31:
        raise ValueError(f"liquid_phi: shape {shape} has 2^31 nodes or more "
                         "(K14's 32-bit offsets)")
    grids = {name: torch.empty(tuple(n + a for n, a in zip(shape, axes)),
                               dtype=torch.float32, device=liquid_phi.device)
             for name, axes in _VOLUME_AXES}
    _build.launch("flip3d_visc_volumes", _VOLUME_ARGS, liquid_phi.data_ptr(),
                  (ctypes.c_void_p * 7)(*(g.data_ptr()
                                          for g in grids.values())),
                  (ctypes.c_int * 7)(*(i + 2 * j + 4 * k
                                       for _, (i, j, k) in _VOLUME_AXES)),
                  (ctypes.c_int * 3)(*shape),
                  plane_chunk(nodes, _build.sm_count(liquid_phi)), _INV12)
    _build.count(compute_volume_grids)
    return VolumeGrids(**grids)


_ASSEMBLE_ARGS = (ctypes.POINTER(ctypes.c_void_p),
                  ctypes.POINTER(ctypes.c_int), _build.F, _build.F, _build.P)
_RHS_ARGS = (ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
             _build.P)


@_build.counted
def build_viscosity_system(u, v, w, volumes: VolumeGrids, states: FaceStates,
                           viscosity_node, dt, cfg: SimConfig, row_masks=None
                           ) -> ViscositySystem:
    """The coupled system of build_viscosity_system_ref; `row_masks`
    (maskU, maskV, maskW) replaces the rows' index ranges ([1, size) per
    axis), as the slab pipeline passes its slabs' ranges in the GLOBAL
    domain. Takes that plain version for CPU tensors. For CUDA tensors it
    launches K14's assembly kernel (csrc/visc_build.cu: rows, factors,
    diagonals, face volumes and the solid-Dirichlet velocities of all three
    components), K13 for the RHS coupling and K14's RHS kernel, each
    bit-equal to the plain version; there is no fallback between the two."""
    dev = u.device
    vels = (u, v, w)
    solids = (states.solid_u, states.solid_v, states.solid_w)
    for c, vel in enumerate(vels):
        name = "uvw"[c]
        _build.require(vel, name, torch.float32, device=dev, ndim=3)
        _build.require(solids[c], f"states.solid_{name}", torch.bool,
                       vel.shape, dev)
        if row_masks is not None:
            _build.require(row_masks[c], f"row_masks[{c}]", torch.bool,
                           vel.shape, dev)
    for field in dataclasses.fields(volumes):
        _build.require(getattr(volumes, field.name), f"volumes.{field.name}",
                       torch.float32, device=dev, ndim=3)
    _build.require(viscosity_node, "viscosity_node", torch.float32,
                   device=dev, ndim=3)
    if _build.on_cpu(u, "build_viscosity_system"):
        return build_viscosity_system_ref(u, v, w, volumes, states,
                                          viscosity_node, dt, cfg, row_masks)
    factor = float(np.float32(dt) / np.float32(cfg.dx * cfg.dx))
    ptrs, ints = [], []
    in_mat, diags, vols, factors, dirichlet = [], [], [], [], []
    for comp, (visc_spec, vol_spec, doubled, own) in enumerate(_ROWS):
        vel = vels[comp]
        rows = torch.empty(vel.shape, dtype=torch.bool, device=dev)
        diag, vol, xd = (torch.empty_like(vel) for _ in range(3))
        fac = {key: torch.empty_like(vel) for key in _KEYS}
        own_grid = getattr(volumes, own)
        key_grids = [getattr(volumes, vol_spec[key][0]) for key in _KEYS]
        ptrs += [vel.data_ptr(), solids[comp].data_ptr(),
                 None if row_masks is None else row_masks[comp].data_ptr(),
                 rows.data_ptr(), diag.data_ptr(), vol.data_ptr(),
                 *(fac[key].data_ptr() for key in _KEYS), xd.data_ptr(),
                 own_grid.data_ptr(), *(g.data_ptr() for g in key_grids)]
        ints += [*vel.shape, *own_grid.shape]
        for key, grid in zip(_KEYS, key_grids):
            offs = visc_spec[key]
            ints += [*grid.shape, *vol_spec[key][1], len(offs),
                     *(x for o in offs for x in o),
                     *(0 for _ in range(3 * (4 - len(offs)))),
                     int(key in doubled)]
        in_mat.append(rows)
        diags.append(diag)
        vols.append(vol)
        factors.append(fac)
        dirichlet.append(xd)
    ptrs.append(viscosity_node.data_ptr())
    ints += [*viscosity_node.shape, cfg.isize, cfg.jsize, cfg.ksize]
    _build.launch("flip3d_visc_assemble", _ASSEMBLE_ARGS,
                  (ctypes.c_void_p * len(ptrs))(*ptrs),
                  (ctypes.c_int * len(ints))(*ints), factor, 2 * factor)
    _build.count(build_viscosity_system)

    # RHS: vol*vel minus the coupling applied to solid-Dirichlet velocities
    with trace.span("viscosity_operator"):
        coupling = viscosity_operator(factors, tuple(dirichlet))
    rhs = [torch.empty_like(vel) for vel in vels]
    ptrs = [t.data_ptr() for group in zip(in_mat, vols, vels, coupling, rhs)
            for t in group]
    _build.launch("flip3d_visc_rhs", _RHS_ARGS,
                  (ctypes.c_void_p * 15)(*ptrs),
                  (ctypes.c_int * 3)(*(vel.numel() for vel in vels)))
    _build.count(build_viscosity_system)
    return ViscositySystem(tuple(in_mat), tuple(diags), tuple(vols),
                           tuple(factors), tuple(rhs))


def apply_viscosity_matrix(sys: ViscositySystem, x):
    """Coupled operator apply (viscosity_operator); coefficients are
    premasked to the rows."""
    with trace.span("viscosity_operator"):
        return viscosity_operator(sys.factors, tuple(x), sys.diag)


def spanned_preconditioner(apply_M):
    """The viscosity solve's preconditioner with each apply spanned
    "viscosity_precond" (inside pcg.apply_M, which the pressure solve's
    V-cycles share): iterations + 1 calls a solve."""

    def apply(r):
        with trace.span("viscosity_precond"):
            return apply_M(r)

    return apply


def solve_viscosity(sys: ViscositySystem, cfg: SimConfig, warm_start=None):
    """PCG on the coupled system, tol = rtol * ||rhs||_inf; `warm_start`
    (the pre-solve velocities) is masked to the rows."""
    bnorm = torch.stack([r.abs().max() for r in sys.rhs]).max()
    tol = torch.tensor(cfg.viscosity_solve_rtol, dtype=torch.float32,
                       device=bnorm.device) * bnorm
    x0 = None
    if warm_start is not None:
        x0 = tuple(torch.where(m, x, torch.zeros_like(x))
                   for m, x in zip(sys.in_mat, warm_start))
    if cfg.viscosity_preconditioner == "multigrid":
        from .multigrid import viscosity_mg_preconditioner

        precon = viscosity_mg_preconditioner(sys, cfg)
    else:
        precon = jacobi_preconditioner(sys.diag)
    return pcg(lambda x: apply_viscosity_matrix(sys, x), sys.rhs,
               spanned_preconditioner(precon), tol,
               cfg.viscosity_solve_max_iterations, x0=x0)


def apply_viscosity_solution(u, v, w, sys: ViscositySystem, result, cfg):
    """Write the solution to matrix faces and zero all other faces; leave
    the field untouched if the solve failed (not converged and residual >=
    the acceptable error)."""
    ok = result.converged or trace.read(
        "viscosity_residual", result.residual) < cfg.viscosity_acceptable_error
    if not ok:
        return u, v, w
    return tuple(torch.where(m, x, torch.zeros_like(x))
                 for m, x in zip(sys.in_mat, result.x))
