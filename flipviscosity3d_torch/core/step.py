"""The FLIP substep and the CFL-driven advance loop.

Counterpart of flipviscosity3d_tpu/core/step.py (reference
fluidsimulation.cpp:135-168) on the one particle engine the port has: the
JAX "pallas" engine with pass A = "sort", pass B = "sort" and pushback =
"gather" (see config.py). Unlike the JAX "sort" pass B, the particles keep
the pass-A order through pass B instead of being re-sorted by midpoint; the
order of particles is not part of the result.

The advance loop runs on the host: one read of max|u| from the card per
substep gives the CFL substep, with the same f32 arithmetic as the JAX
while loop, so substep counts match. Divergences from the reference are the
JAX package's (multigrid / Jacobi PCG in f32, clamp -> pushback -> clamp,
a substep cap).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..ops import pallas_particles as pp
from ..ops.buckets import cell_of_position
from ..ops.extrapolate import extrapolate_velocity_field
from ..ops.grids import (
    face_borders_fluid_u,
    face_borders_fluid_v,
    face_borders_fluid_w,
)
from ..ops.particle_grid import liquid_sdf_from_particles
from ..ops.stream_transfers import solid_pushback_at
from ..solvers import pressure as psolver
from ..solvers import viscosity as vsolver
from .state import SimState, StepDiagnostics

_P2G_EPS = 1e-9  # weight threshold (fluidsimulation.cpp:423-431)


def _clamp_bounds(cfg: SimConfig):
    """Particle containment box (lo, (hi_x, hi_y, hi_z)) as f32 values:
    the domain inset by dx + 5e-5 per side, with the nearest-point clamp's
    1e-6 pullback on the high side (fluidsimulation.cpp:319-320,
    aabb.cpp:118-124, :217-234)."""
    lo = float(np.float32(cfg.dx + 0.5e-4))
    his = tuple(float(np.float32(n * cfg.dx - cfg.dx - 0.5e-4 - 1e-6))
                for n in (cfg.isize, cfg.jsize, cfg.ksize))
    return lo, his


def _max_velocity(u, v, w):
    """CFL velocity magnitude: max component magnitude over all faces."""
    return torch.maximum(u.abs().max(),
                         torch.maximum(v.abs().max(), w.abs().max()))


def _grid_update(state: SimState, liquid_phi, p2g_sums, dt: float,
                 cfg: SimConfig):
    """Between P2G and G2P: normalize the transfer, extrapolate, body force,
    viscosity, pressure projection, extrapolate, constrain
    (fluidsimulation.cpp:149-161)."""
    solid = state.solid
    fluid = liquid_phi < 0
    borders = (face_borders_fluid_u(fluid), face_borders_fluid_v(fluid),
               face_borders_fluid_w(fluid))

    vel, valid = [], []
    for (vsum, wsum), b in zip(p2g_sums, borders):
        is_set = wsum >= _P2G_EPS
        vals = vsum / torch.clamp(wsum, min=_P2G_EPS)
        mask = is_set & b
        vel.append(torch.where(mask, vals, torch.zeros_like(vals)))
        valid.append(mask)
    u, v, w, *_ = extrapolate_velocity_field(*vel, *valid,
                                             cfg.extrapolation_layers)
    saved = (u, v, w)  # FLIP delta baseline

    # body force on faces bordering fluid (fluidsimulation.cpp:271-312)
    u, v, w = (torch.where(b, g + state.gravity[a] * dt, g)
               for a, (g, b) in enumerate(zip((u, v, w), borders)))

    # viscosity (fluidsimulation.cpp:170-196), skipped when all zero
    visc_iters, visc_res = 0, 0.0
    if bool((state.viscosity > 0).any()):
        volumes = vsolver.compute_volume_grids(liquid_phi, cfg)
        states = vsolver.FaceStates(solid.solid_u, solid.solid_v,
                                    solid.solid_w)
        vsys = vsolver.build_viscosity_system(
            u, v, w, volumes, states, state.viscosity, dt, cfg)
        result = vsolver.solve_viscosity(vsys, cfg, warm_start=(u, v, w))
        u, v, w = vsolver.apply_viscosity_solution(u, v, w, vsys, result, cfg)
        visc_iters, visc_res = result.iterations, result.residual

    # pressure projection (fluidsimulation.cpp:522-531)
    psys = psolver.build_pressure_system(
        u, v, w, liquid_phi, solid.weight_u, solid.weight_v, solid.weight_w,
        dt, cfg)
    pres = psolver.solve_pressure(psys, cfg)
    u, v, w, *valid = psolver.apply_pressure(
        u, v, w, pres.x[0], liquid_phi,
        solid.weight_u, solid.weight_v, solid.weight_w, dt, cfg)
    u, v, w, *_ = extrapolate_velocity_field(u, v, w, *valid,
                                             cfg.extrapolation_layers)

    # constrain: zero both fields at fully closed faces
    # (fluidsimulation.cpp:696-729)
    weights = (solid.weight_u, solid.weight_v, solid.weight_w)
    new = tuple(torch.where(wt == 0, torch.zeros_like(g), g)
                for g, wt in zip((u, v, w), weights))
    saved = tuple(torch.where(wt == 0, torch.zeros_like(g), g)
                  for g, wt in zip(saved, weights))
    solver_diag = dict(
        pressure_iterations=pres.iterations,
        pressure_residual=pres.residual,
        pressure_tolerance=pres.tol,
        viscosity_iterations=visc_iters,
        viscosity_residual=visc_res,
        liquid_cells=fluid.sum(),
    )
    return new, saved, solver_diag


def step(state: SimState, dt: float, cfg: SimConfig):
    """One CFL substep: pass A (sort, P2G scatter + SDF table, grid update,
    G2P gather), pass B (stage-2 sample at the RK2 midpoints), clamp, solid
    pushback, clamp. `dt` is a Python float holding an f32 value. Returns
    (state, diagnostics pieces)."""
    dx = cfg.dx
    shape = cfg.grid_shape
    pp.check_grid(shape)
    solid = state.solid
    cap = cfg.sdf_cap

    # ---------------- PASS A ----------------
    stream = pp.tiled_sort(state.pos, state.vel, dx, shape)
    sums, table = pp.scatter_p2g_table(
        stream.pos, stream.vel, stream.key, stream.rank, shape, dx, cap)
    overflow_a = (stream.rank >= cap).sum()
    liquid_phi = liquid_sdf_from_particles(
        pp.table_fields(table, cap), shape, dx, cfg.particle_radius,
        solid.center_phi)
    p2g_sums = pp.p2g_combine(sums, shape,
                              (cfg.u_shape, cfg.v_shape, cfg.w_shape))

    (u, v, w), (su, sv, sw), solver_diag = _grid_update(
        state, liquid_phi, p2g_sums, dt, cfg)

    # ---------------- G2P + advection ----------------
    spx, spy, spz = (stream.pos[:, a].contiguous() for a in range(3))
    svx, svy, svz = stream.vel.unbind(dim=1)
    gm = pp.gather_mac(spx, spy, spz, stream.key, [u, su], [v, sv], [w, sw],
                       dx, shape)
    nu, nv, nw, ou, ov, ow = gm.unbind(dim=0)   # rows g*3 + comp
    r = np.float32(cfg.ratio_pic_flip)
    r, s = float(r), float(np.float32(1.0) - r)
    vel_x = r * nu + s * (svx + nu - ou)
    vel_y = r * nv + s * (svy + nv - ov)
    vel_z = r * nw + s * (svz + nw - ow)

    # RK2 stage 1 midpoint from the grid velocity (fluidsimulation.cpp:535)
    half = 0.5 * dt
    mx = spx + half * nu
    my = spy + half * nv
    mz = spz + half * nw

    # ---------------- PASS B: every midpoint sampled directly ----------------
    key_m = pp.key_of_position(torch.stack([mx, my, mz], dim=1), dx, shape)
    gmb = pp.gather_mac(mx, my, mz, key_m, [u], [v], [w], dx, shape)
    inside_m = ((mx >= 0) & (mx < shape[0] * dx)
                & (my >= 0) & (my < shape[1] * dx)
                & (mz >= 0) & (mz < shape[2] * dx))
    zero = torch.zeros_like(mx)
    v2 = [torch.where(inside_m, gmb[c], zero) for c in range(3)]
    fnp = [p + dt * vv for p, vv in zip((spx, spy, spz), v2)]

    # ---------------- clamp + solid pushback ----------------
    lo, his = _clamp_bounds(cfg)
    cp = [torch.clamp(p, lo, hi) for p, hi in zip(fnp, his)]
    key_c = cell_of_position(torch.stack(cp, dim=1), dx, shape)
    dp = solid_pushback_at(*cp, key_c, solid.phi, dx, shape)
    final = [torch.clamp(c + d, lo, hi) for c, d, hi in zip(cp, dp, his)]

    new_state = state.replace(
        pos=torch.stack(final, dim=1),
        vel=torch.stack([vel_x, vel_y, vel_z], dim=1),
        u=u, v=v, w=w)
    return new_state, dict(bucket_overflow=overflow_a, **solver_diag)


def advance(state: SimState, dt: float, cfg: SimConfig):
    """Advance by a frame of length dt with CFL substeps
    (fluidsimulation.cpp:135-168). Returns (state, StepDiagnostics)."""
    f32 = np.float32
    dt = f32(dt)
    t = f32(0.0)
    diag = StepDiagnostics()
    overflow = []
    while t < dt and diag.substeps < cfg.max_substeps:
        maxvel = f32(_max_velocity(state.u, state.v, state.w).item())
        cfl = f32(cfg.cfl_number * cfg.dx) / maxvel if maxvel > 0 else \
            f32(np.inf)
        substep = min(cfl, f32(dt - t))
        state, d = step(state, float(substep), cfg)
        diag.substeps += 1
        diag.pressure_iterations += d["pressure_iterations"]
        diag.pressure_residual = d["pressure_residual"]
        diag.pressure_tolerance = d["pressure_tolerance"]
        diag.viscosity_iterations += d["viscosity_iterations"]
        diag.viscosity_residual = d["viscosity_residual"]
        diag.max_velocity = max(diag.max_velocity, float(maxvel))
        diag.liquid_cells = d["liquid_cells"]
        overflow.append(d["bucket_overflow"])
        t = f32(t + substep)
    diag.pressure_residual = float(diag.pressure_residual)
    diag.pressure_tolerance = float(diag.pressure_tolerance)
    diag.viscosity_residual = float(diag.viscosity_residual)
    diag.liquid_cells = int(diag.liquid_cells)
    diag.bucket_overflow = int(sum(int(o) for o in overflow))
    return state, diag
