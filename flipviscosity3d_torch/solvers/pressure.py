"""Variational ghost-fluid pressure projection, matrix-free.

Counterpart of flipviscosity3d_tpu/solvers/pressure.py (reference
pressuresolver.cpp:160-567 and fluidsimulation.cpp:598-688): dense
coefficient grids, a 7-point stencil under PCG with a relative tolerance
floor, and the pressure gradient applied to faces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimConfig
from ..ops.grids import (
    face_borders_fluid_u,
    face_borders_fluid_v,
    face_borders_fluid_w,
    range_mask,
    shifted_read,
)
from ..ops.levelset import fraction_inside
from .pcg import PCGResult, jacobi_preconditioner, pcg


@dataclasses.dataclass
class PressureSystem:
    fluid: torch.Tensor     # (I,J,K) bool: row mask (interior fluid cells)
    diag: torch.Tensor
    plus_i: torch.Tensor    # coupling to (i+1,j,k)
    plus_j: torch.Tensor
    plus_k: torch.Tensor
    b: torch.Tensor         # RHS (negative divergence)
    theta_u: torch.Tensor   # clamped liquid face fractions
    theta_v: torch.Tensor
    theta_w: torch.Tensor


def liquid_face_weights(liquid_phi):
    """1D inside-fractions on every interior face
    (particlelevelset.cpp:54-75); boundary faces are 0."""
    out = []
    for axis in range(3):
        n = liquid_phi.shape[axis]
        lo = liquid_phi.narrow(axis, 0, n - 1)
        hi = liquid_phi.narrow(axis, 1, n - 1)
        zshape = list(liquid_phi.shape)
        zshape[axis] = 1
        z = torch.zeros(zshape, dtype=liquid_phi.dtype,
                        device=liquid_phi.device)
        out.append(torch.cat([z, fraction_inside(lo, hi), z], dim=axis))
    return tuple(out)


def build_pressure_system(u, v, w, liquid_phi, weight_u, weight_v, weight_w,
                          dt, cfg: SimConfig) -> PressureSystem:
    """Rows are interior fluid cells (indices in [1, size-2] per axis)."""
    shape = tuple(liquid_phi.shape)
    dev = liquid_phi.device
    interior = range_mask(shape, (1, 1, 1),
                          (shape[0] - 1, shape[1] - 1, shape[2] - 1), dev)
    fluid = (liquid_phi < 0) & interior
    fluid_f = fluid.to(torch.float32)

    div = (
        weight_u[:-1] * u[:-1] - weight_u[1:] * u[1:]
        + weight_v[:, :-1] * v[:, :-1] - weight_v[:, 1:] * v[:, 1:]
        + weight_w[:, :, :-1] * w[:, :, :-1] - weight_w[:, :, 1:] * w[:, :, 1:]
    ) / cfg.dx
    b = div * fluid_f

    scale = float(np.float32(dt) / np.float32(cfg.dx * cfg.dx))
    fw_u, fw_v, fw_w = liquid_face_weights(liquid_phi)
    theta_u = torch.clamp(fw_u, min=cfg.minfrac)
    theta_v = torch.clamp(fw_v, min=cfg.minfrac)
    theta_w = torch.clamp(fw_w, min=cfg.minfrac)

    diag = torch.zeros(shape, dtype=torch.float32, device=dev)
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    plus = {}
    specs = [
        (0, +1, weight_u[1:], theta_u[1:]),
        (0, -1, weight_u[:-1], theta_u[:-1]),
        (1, +1, weight_v[:, 1:], theta_v[:, 1:]),
        (1, -1, weight_v[:, :-1], theta_v[:, :-1]),
        (2, +1, weight_w[:, :, 1:], theta_w[:, :, 1:]),
        (2, -1, weight_w[:, :, :-1], theta_w[:, :, :-1]),
    ]
    for axis, sign, wgt, theta in specs:
        off = [0, 0, 0]
        off[axis] = sign
        nphi = shifted_read(liquid_phi, tuple(off), shape, fill=float("inf"))
        term = wgt * scale
        nb_fluid = nphi < 0
        diag = diag + torch.where(nb_fluid, term, term / theta) * fluid_f
        if sign == +1:
            plus[axis] = torch.where(nb_fluid & fluid, -term, zero)
    return PressureSystem(fluid, diag, plus[0], plus[1], plus[2], b,
                          theta_u, theta_v, theta_w)


def apply_pressure_matrix(sys: PressureSystem, x):
    """7-point SPD stencil apply (pressuresolver.cpp:464-499); the result is
    masked to the rows."""
    shape = x.shape
    y = sys.diag * x
    for axis, plus in ((0, sys.plus_i), (1, sys.plus_j), (2, sys.plus_k)):
        up = [0, 0, 0]
        up[axis] = 1
        dn = [0, 0, 0]
        dn[axis] = -1
        y = y + plus * shifted_read(x, tuple(up), shape)
        y = y + shifted_read(plus * x, tuple(dn), shape)
    return torch.where(sys.fluid, y, torch.zeros_like(y))


def solve_pressure(sys: PressureSystem, cfg: SimConfig) -> PCGResult:
    """PCG with tol = max(abs_tol, rtol * ||b||_inf)."""
    bnorm = sys.b.abs().max()
    tol = torch.maximum(
        torch.tensor(cfg.pressure_solve_tolerance, dtype=torch.float32,
                     device=bnorm.device),
        torch.tensor(cfg.pressure_solve_rtol, dtype=torch.float32,
                     device=bnorm.device) * bnorm,
    )
    if cfg.pressure_preconditioner == "multigrid":
        from .multigrid import pressure_mg_preconditioner

        precon = pressure_mg_preconditioner(sys, cfg)
    else:
        precon = jacobi_preconditioner((sys.diag,))
    return pcg(
        lambda x: (apply_pressure_matrix(sys, x[0]),),
        (sys.b,),
        precon,
        tol,
        cfg.pressure_solve_max_iterations,
    )


def apply_pressure(u, v, w, pressure, liquid_phi, weight_u, weight_v,
                   weight_w, dt, cfg: SimConfig):
    """Subtract the pressure gradient on valid faces and zero all others
    (fluidsimulation.cpp:598-688). Returns (u, v, w, valid_u, valid_v,
    valid_w)."""
    dx = cfg.dx
    dev = liquid_phi.device
    fluid = liquid_phi < 0
    fws = liquid_face_weights(liquid_phi)
    borders = (face_borders_fluid_u(fluid), face_borders_fluid_v(fluid),
               face_borders_fluid_w(fluid))
    out_vel, out_mask = [], []
    for axis, (vel, weight) in enumerate(
            ((u, weight_u), (v, weight_v), (w, weight_w))):
        shape = tuple(vel.shape)
        lo = [0, 0, 0]
        hi = list(shape)
        lo[axis] = 1
        hi[axis] = shape[axis] - 1
        inner = range_mask(shape, lo, hi, dev)
        theta = torch.clamp(fws[axis], min=cfg.minfrac)
        n = pressure.shape[axis]
        grad = torch.zeros(shape, dtype=torch.float32, device=dev)
        sl = [slice(None)] * 3
        sl[axis] = slice(1, -1)
        grad[tuple(sl)] = (pressure.narrow(axis, 1, n - 1)
                           - pressure.narrow(axis, 0, n - 1))
        mask = inner & (weight > 0) & borders[axis]
        out_vel.append(torch.where(mask, vel - dt * grad / (dx * theta),
                                   torch.zeros_like(vel)))
        out_mask.append(mask)
    return (*out_vel, *out_mask)
