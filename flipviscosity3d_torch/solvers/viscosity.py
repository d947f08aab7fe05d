"""Batty-Bridson variational viscosity solve, matrix-free and coupled.

Counterpart of flipviscosity3d_tpu/solvers/viscosity.py (reference
viscositysolver.cpp:41-727): face states, the 7 control-volume fraction
grids, the coupled U/V/W system with solid-Dirichlet velocities moved to the
RHS, PCG with a relative inf-norm tolerance, and the write-back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

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


def compute_volume_grids(liquid_phi, cfg: SimConfig) -> VolumeGrids:
    """The 7 control-volume fraction grids (viscositysolver.cpp:135-270),
    restricted to the fluid mask dilated 2 layers over the (I+1,J+1,K+1)
    valid-cell grid. An axis with a half-cell centerStart samples corner phi
    at cell centers (identity), otherwise at midpoints (2-point average)."""
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


def build_viscosity_system(u, v, w, volumes: VolumeGrids, states: FaceStates,
                           viscosity_node, dt, cfg: SimConfig, row_masks=None
                           ) -> ViscositySystem:
    """`row_masks` (maskU, maskV, maskW) replaces the rows' index ranges
    ([1, size) per axis, the reference's assembly loop bounds); the slab
    pipeline passes its slabs' ranges in the GLOBAL domain."""
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
    cu, cv, cw = _apply_coupling(
        factors, *(vel * s.to(torch.float32) for vel, s in zip(vels, solids)))
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


def apply_viscosity_matrix(sys: ViscositySystem, x):
    """Coupled operator apply; coefficients are premasked to the rows."""
    xu, xv, xw = x
    cu, cv, cw = _apply_coupling(sys.factors, xu, xv, xw)
    return (sys.diag[0] * xu + cu, sys.diag[1] * xv + cv,
            sys.diag[2] * xw + cw)


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
    return pcg(lambda x: apply_viscosity_matrix(sys, x), sys.rhs, precon,
               tol, cfg.viscosity_solve_max_iterations, x0=x0)


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
