"""The FLIP substep and the CFL-driven advance loop.

Counterpart of flipviscosity3d_tpu/core/step.py (reference
fluidsimulation.cpp:135-168) on the one particle engine the port has, the
JAX "pallas" engine (`_step_pallas`), with its three visit-plan switches
(config.py): pass A "sort" or "stale", pass B "plan" or "sort", pushback
"gather" or "kernel". At >= 2^24 cells the scatter folds its sums and the
face combine runs in slabs, each by the JAX package's own rule. The
particles leave every substep in the JAX package's order: the order decides
which particles a visit plan covers and which fill the SDF table, so it is
part of the result.

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
from ..ops.stream_transfers import pushback_from_corners, solid_pushback_at
from ..solvers import pressure as psolver
from ..solvers import viscosity as vsolver
from .state import SimState, StepDiagnostics

_P2G_EPS = 1e-9  # weight threshold (fluidsimulation.cpp:423-431)
# per-substep counts that advance sums over the frame, read once at its end
# (a plan's count is absent where the variant has no plan), as are the
# plans' visits ("plan_visits", the most any plan of the substep asked for)
_COUNTED = ("bucket_overflow", "uncovered_pass_a", "uncovered_pass_b",
            "uncovered_pushback")


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
    visc_iters, visc_res, visc_tol = 0, 0.0, 0.0
    if bool((state.viscosity > 0).any()):
        volumes = vsolver.compute_volume_grids(liquid_phi, cfg)
        states = vsolver.FaceStates(solid.solid_u, solid.solid_v,
                                    solid.solid_w)
        vsys = vsolver.build_viscosity_system(
            u, v, w, volumes, states, state.viscosity, dt, cfg)
        result = vsolver.solve_viscosity(vsys, cfg, warm_start=(u, v, w))
        u, v, w = vsolver.apply_viscosity_solution(u, v, w, vsys, result, cfg)
        visc_iters, visc_res = result.iterations, result.residual
        visc_tol = result.tol

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
        viscosity_tolerance=visc_tol,
        liquid_cells=fluid.sum(),
    )
    return new, saved, solver_diag


def _gather_grids(cfg: SimConfig, *grids):
    """The grids as G2P and the midpoint sample read them: under
    pallas_gather_dtype "bf16" rounded to bf16 (round to nearest even) and
    widened back, which is what storing the JAX column image in bf16 does
    to every value it holds; under "f32" the grids themselves."""
    if cfg.pallas_gather_dtype == "bf16":
        return tuple(g.to(torch.bfloat16).float() for g in grids)
    return grids


def runs_stale(cfg: SimConfig, substep_idx) -> bool:
    """Whether substep `substep_idx` (None for 0) keeps the previous
    substep's particle order: pass A "stale", except on every
    pallas_resort_every-th substep."""
    return (cfg.pallas_pass_a == "stale"
            and (substep_idx or 0) % cfg.pallas_resort_every != 0)


def _pass_a(state: SimState, cfg: SimConfig, substep_idx):
    """Pass A's particle order, P2G sums and slot table -> (pos, vel, key,
    plan or None, sums, table, table overflow). "sort": a stable sort by
    home key every substep, ranks from the runs. "stale": the state's order
    (re-sorted unless runs_stale); the plan leaves uncovered particles out
    of the scatter and the ranks come from the kernel."""
    dx, shape, cap = cfg.dx, cfg.grid_shape, cfg.sdf_cap
    if cfg.pallas_pass_a == "sort":
        stream = pp.tiled_sort(state.pos, state.vel, dx, shape)
        sums, table = pp.scatter_p2g_table(
            stream.pos, stream.vel, stream.key, stream.rank, shape, dx, cap)
        overflow = (stream.rank >= cap).sum()
        return (stream.pos, stream.vel, stream.key, None, sums, table,
                overflow)
    pos, vel = state.pos, state.vel
    key = pp.key_of_position(pos, dx, shape)
    if not runs_stale(cfg, substep_idx):
        key, (pos, vel) = pp.sort_by_key(key, (pos, vel))
    plan = pp.plan_pass_a(key, shape, cfg.pallas_passa_budget,
                          cfg.pallas_passa_factor)
    sums, table, counts = pp.scatter_p2g_table_stale(
        pos, vel, key, plan, shape, dx, cap)
    return (pos, vel, key, plan, sums, table,
            pp.table_rank_overflow(counts, cap))


def step(state: SimState, dt: float, cfg: SimConfig, substep_idx=None):
    """One CFL substep: pass A (P2G scatter + SDF table, grid update, G2P
    gather), pass B (stage-2 sample at the RK2 midpoints), clamp, solid
    pushback, clamp, under cfg's pallas_pass_a / pallas_pass_b /
    pallas_pushback variants. `dt` is a Python float holding an f32 value;
    `substep_idx` (the advance loop's counter, None for 0) sets the stale
    pass A's re-sort cadence. Returns (state, diagnostics pieces)."""
    dx = cfg.dx
    shape = cfg.grid_shape
    pp.check_grid(shape)
    solid = state.solid
    cap = cfg.sdf_cap

    # ---------------- PASS A ----------------
    pos_a, vel_a, key_a, plan_a, sums, table, overflow = _pass_a(
        state, cfg, substep_idx)
    uncovered = {}   # per visit plan, the particles it left uncovered
    visits = []      # per visit plan, the visits its chunks asked for
    liquid_phi = liquid_sdf_from_particles(
        pp.table_fields(table, cap), shape, dx, cfg.particle_radius,
        solid.center_phi)
    p2g_sums = pp.p2g_combine(sums, shape,
                              (cfg.u_shape, cfg.v_shape, cfg.w_shape))
    del sums, table   # gigabytes at 256^3; nothing below reads them

    (u, v, w), (su, sv, sw), solver_diag = _grid_update(
        state, liquid_phi, p2g_sums, dt, cfg)

    # ---------------- G2P + advection ----------------
    spx, spy, spz = (pos_a[:, a].contiguous() for a in range(3))
    svx, svy, svz = vel_a.unbind(dim=1)
    gu, gv, gw, gsu, gsv, gsw = _gather_grids(cfg, u, v, w, su, sv, sw)
    gm = pp.gather_mac(spx, spy, spz, key_a, [gu, gsu], [gv, gsv],
                       [gw, gsw], dx, shape)
    nu, nv, nw, ou, ov, ow = gm.unbind(dim=0)   # rows g*3 + comp
    if plan_a is not None:
        # uncovered particles advect ballistically: new == old == own
        # velocity makes the FLIP update a no-op
        covered_a = plan_a.covered
        uncovered["uncovered_pass_a"] = (~covered_a).sum()
        visits.append(plan_a.visits)
        nu, ou = (torch.where(covered_a, g, svx) for g in (nu, ou))
        nv, ov = (torch.where(covered_a, g, svy) for g in (nv, ov))
        nw, ow = (torch.where(covered_a, g, svz) for g in (nw, ow))
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

    # ---------------- PASS B: stage-2 sample at the midpoints ----------------
    key_m = pp.key_of_position(torch.stack([mx, my, mz], dim=1), dx, shape)
    fields = (mx, my, mz, spx, spy, spz, vel_x, vel_y, vel_z)
    sample_ok = None
    if cfg.pallas_pass_b == "plan":
        # pass-A order; uncovered midpoints advect ballistically (counted)
        plan_b = pp.plan_midpoint_visits(
            key_m, cfg.pallas_midpoint_budget, cfg.pallas_midpoint_factor)
        sample_ok = plan_b.covered
        uncovered["uncovered_pass_b"] = (~sample_ok).sum()
        visits.append(plan_b.visits)
    else:
        key_m, fields = pp.sort_by_key(key_m, fields)
    bmx, bmy, bmz, bpx, bpy, bpz, bvx, bvy, bvz = fields
    gmb = pp.gather_mac(bmx, bmy, bmz, key_m, [gu], [gv], [gw], dx, shape)
    inside_m = ((bmx >= 0) & (bmx < shape[0] * dx)
                & (bmy >= 0) & (bmy < shape[1] * dx)
                & (bmz >= 0) & (bmz < shape[2] * dx))
    zero = torch.zeros_like(bmx)
    v2 = [torch.where(inside_m, gmb[c], zero) for c in range(3)]
    if sample_ok is not None:
        v2 = [torch.where(sample_ok, g, bv)
              for g, bv in zip(v2, (bvx, bvy, bvz))]
    fnp = [p + dt * vv for p, vv in zip((bpx, bpy, bpz), v2)]

    # ---------------- clamp + solid pushback ----------------
    lo, his = _clamp_bounds(cfg)
    cp = [torch.clamp(p, lo, hi) for p, hi in zip(fnp, his)]
    if cfg.pallas_pushback == "kernel":
        # node-SDF corners through a clamped-position visit plan; uncovered
        # particles skip this substep's pushback (counted)
        key_k = pp.key_of_position(torch.stack(cp, dim=1), dx, shape)
        plan_k = pp.plan_midpoint_visits(key_k, cfg.pallas_midpoint_budget,
                                         cfg.pallas_midpoint_factor)
        ok = plan_k.covered
        visits.append(plan_k.visits)
        corners = pp.gather_rows8(key_k, ok, solid.phi, shape)
        home = pp.decode_key(key_k, shape)
        dp = pushback_from_corners(
            list(corners), *(c / dx - h.to(torch.float32)
                             for c, h in zip(cp, home)))
        dp = [torch.where(ok, d, torch.zeros_like(d)) for d in dp]
        uncovered["uncovered_pushback"] = (~ok).sum()
    else:
        key_c = cell_of_position(torch.stack(cp, dim=1), dx, shape)
        dp = solid_pushback_at(*cp, key_c, solid.phi, dx, shape)
    final = [torch.clamp(c + d, lo, hi) for c, d, hi in zip(cp, dp, his)]

    new_state = state.replace(
        pos=torch.stack(final, dim=1),
        vel=torch.stack([bvx, bvy, bvz], dim=1),
        u=u, v=v, w=w)
    # overflow: SDF-table capacity drops, and the particles that the pass-A,
    # midpoint and pushback plans left uncovered
    overflow = overflow + sum(uncovered.values())
    demand = dict(plan_visits=torch.stack(visits).max()) if visits else {}
    return new_state, dict(bucket_overflow=overflow, **uncovered, **demand,
                           **solver_diag)


def advance(state: SimState, dt: float, cfg: SimConfig):
    """Advance by a frame of length dt with CFL substeps
    (fluidsimulation.cpp:135-168). Returns (state, StepDiagnostics)."""
    f32 = np.float32
    dt = f32(dt)
    t = f32(0.0)
    diag = StepDiagnostics()
    counts = {k: [] for k in _COUNTED}
    visits = []
    while t < dt and diag.substeps < cfg.max_substeps:
        maxvel = f32(_max_velocity(state.u, state.v, state.w).item())
        cfl = f32(cfg.cfl_number * cfg.dx) / maxvel if maxvel > 0 else \
            f32(np.inf)
        substep = min(cfl, f32(dt - t))
        diag.stale_substeps += runs_stale(cfg, diag.substeps)
        state, d = step(state, float(substep), cfg,
                        substep_idx=diag.substeps)
        diag.substeps += 1
        diag.pressure_iterations += d["pressure_iterations"]
        diag.pressure_residual = d["pressure_residual"]
        diag.pressure_tolerance = d["pressure_tolerance"]
        diag.viscosity_iterations += d["viscosity_iterations"]
        diag.viscosity_residual = d["viscosity_residual"]
        diag.viscosity_tolerance = d["viscosity_tolerance"]
        diag.max_velocity = max(diag.max_velocity, float(maxvel))
        diag.liquid_cells = d["liquid_cells"]
        for k, v in counts.items():
            v.append(d.get(k, 0))
        visits.append(d.get("plan_visits", 0))
        t = f32(t + substep)
    diag.pressure_residual = float(diag.pressure_residual)
    diag.pressure_tolerance = float(diag.pressure_tolerance)
    diag.viscosity_residual = float(diag.viscosity_residual)
    diag.viscosity_tolerance = float(diag.viscosity_tolerance)
    diag.liquid_cells = int(diag.liquid_cells)
    for k, v in counts.items():
        setattr(diag, k, int(sum(int(o) for o in v)))
    diag.plan_demand = max((int(o) for o in visits), default=0) / (
        pp.n_chunks(state.pos.shape[0]))
    return state, diag
