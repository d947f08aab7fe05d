"""The FLIP substep and the CFL-driven advance loop.

Counterpart of flipviscosity3d_tpu/core/step.py (reference
fluidsimulation.cpp:135-168) on the JAX package's three particle engines
(cfg.particle_engine, config.py):

- "table" (the default): pass A buckets the particles by position into
  (bucket_capacity, n_cells) tables for the fused P2G + SDF sweep and G2P,
  pass B by RK2 midpoint for the stage-2 sample (`_step_table`);
- "stream": one sort per substep, P2G and SDF as segment reductions, the
  samples as row gathers (`_step_stream`);
- "pallas": the tile-major engine whose scatters and gathers are the CUDA
  kernels of csrc/ (`_step_pallas`), with its three visit-plan switches:
  pass A "sort" or "stale", pass B "plan" or "sort", pushback "gather" or
  "kernel". At >= 2^24 cells the scatter folds its sums and the face
  combine runs in slabs, each by the JAX package's own rule.

Every engine shares the grid update (`_grid_update`: both solves) and the
clamp -> pushback -> clamp. The particles leave every substep in the JAX
package's order for that engine (table B's sorted order, pass A's stream,
or the pallas engine's stream): the order decides which particles a table
or a visit plan holds, so it is part of the result.

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
from ..ops import particle_grid as pg
from ..ops import stream_transfers as st
from ..ops.buckets import build_buckets, cell_of_position, gather_results
from ..ops.extrapolate import extrapolate_velocity_field
from ..ops.grids import (
    face_borders_fluid_u,
    face_borders_fluid_v,
    face_borders_fluid_w,
)
# the plain SDF sweep, which the pallas step no longer calls: the
# benchmark's traced run wraps this name (benchmark/trace.py::SPANS)
from ..ops.particle_grid import liquid_sdf_from_particles  # noqa: F401
from ..ops.stream import stream_sort
from ..ops.stream_transfers import pushback_from_corners, solid_pushback_at
from ..solvers import pressure as psolver
from ..solvers import viscosity as vsolver
from ..utils import trace
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
    with trace.span("grid_update"):
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
        with trace.span("extrapolate"):
            u, v, w, *_ = extrapolate_velocity_field(*vel, *valid,
                                                     cfg.extrapolation_layers)
        saved = (u, v, w)  # FLIP delta baseline

        # body force on faces bordering fluid (fluidsimulation.cpp:271-312)
        u, v, w = (torch.where(b, g + state.gravity[a] * dt, g)
                   for a, (g, b) in enumerate(zip((u, v, w), borders)))

        # viscosity (fluidsimulation.cpp:170-196), skipped when all zero
        visc_iters, visc_res, visc_tol = 0, 0.0, 0.0
        visc_solves = visc_unconverged = 0
        if trace.read("viscosity_any", (state.viscosity > 0).any()):
            with trace.span("viscosity_build"):
                volumes = vsolver.compute_volume_grids(liquid_phi, cfg)
                states = vsolver.FaceStates(solid.solid_u, solid.solid_v,
                                            solid.solid_w)
                vsys = vsolver.build_viscosity_system(
                    u, v, w, volumes, states, state.viscosity, dt, cfg)
            with trace.span("viscosity_solve"):
                result = vsolver.solve_viscosity(vsys, cfg,
                                                 warm_start=(u, v, w))
            with trace.span("viscosity_apply"):
                u, v, w = vsolver.apply_viscosity_solution(
                    u, v, w, vsys, result, cfg)
            visc_iters, visc_res = result.iterations, result.residual
            visc_tol = result.tol
            visc_solves, visc_unconverged = 1, int(not result.converged)

        # pressure projection (fluidsimulation.cpp:522-531)
        with trace.span("pressure_build"):
            psys = psolver.build_pressure_system(
                u, v, w, liquid_phi, solid.weight_u, solid.weight_v,
                solid.weight_w, dt, cfg)
        with trace.span("pressure_solve"):
            pres = psolver.solve_pressure(psys, cfg)
        with trace.span("pressure_apply"):
            u, v, w, *valid = psolver.apply_pressure(
                u, v, w, pres.x[0], liquid_phi,
                solid.weight_u, solid.weight_v, solid.weight_w, dt, cfg)
        with trace.span("extrapolate"):
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
            viscosity_solves=visc_solves,
            viscosity_unconverged=visc_unconverged,
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
    substep's particle order: the "pallas" engine's pass A "stale", except
    on every pallas_resort_every-th substep."""
    return (cfg.particle_engine == "pallas"
            and cfg.pallas_pass_a == "stale"
            and (substep_idx or 0) % cfg.pallas_resort_every != 0)


def _pass_a(state: SimState, cfg: SimConfig, substep_idx):
    """Pass A's particle order, P2G sums and slot table -> (pos, vel, key,
    plan or None, sums, table, table overflow). "sort": a stable sort by
    home key every substep, ranks from the runs. "stale": the state's order
    (re-sorted unless runs_stale); the plan leaves uncovered particles out
    of the scatter and the ranks come from the kernel."""
    dx, shape, cap = cfg.dx, cfg.grid_shape, cfg.sdf_cap
    terms = cfg.pallas_split_terms
    if cfg.pallas_pass_a == "sort":
        stream = pp.tiled_sort(state.pos, state.vel, dx, shape)
        sums, table = pp.scatter_p2g_table(
            stream.pos, stream.vel, stream.key, stream.rank, shape, dx, cap,
            terms=terms)
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
        pos, vel, key, plan, shape, dx, cap, terms=terms)
    return (pos, vel, key, plan, sums, table,
            pp.table_rank_overflow(counts, cap))


def _pic_flip(cfg: SimConfig, new, old, own):
    """The PIC/FLIP velocity update (fluidsimulation.cpp:341-352) of one
    component: r * new + (1 - r) * (own + new - old), r in f32."""
    r = np.float32(cfg.ratio_pic_flip)
    r, s = float(r), float(np.float32(1.0) - r)
    return r * new + s * (own + new - old)


def _inside(mx, my, mz, shape, dx):
    """Whether positions lie in the domain box [0, n * dx) on every axis."""
    return ((mx >= 0) & (mx < shape[0] * dx)
            & (my >= 0) & (my < shape[1] * dx)
            & (mz >= 0) & (mz < shape[2] * dx))


def _clamp_and_push_back(fnp, solid, cfg: SimConfig):
    """Clamp, push out of solids through one (N, 8) row gather of the node
    SDF keyed by the clamped home cell (every particle), clamp again ->
    (N, 3) positions."""
    dx, shape = cfg.dx, cfg.grid_shape
    lo, his = _clamp_bounds(cfg)
    cp = [torch.clamp(p, lo, hi) for p, hi in zip(fnp, his)]
    key_c = cell_of_position(torch.stack(cp, dim=1), dx, shape)
    dp = solid_pushback_at(*cp, key_c, solid.phi, dx, shape)
    return torch.stack([torch.clamp(c + d, lo, hi)
                        for c, d, hi in zip(cp, dp, his)], dim=1)


def _step_table(state: SimState, dt: float, cfg: SimConfig):
    """One CFL substep on the bucket-table engine: pass A buckets by
    position (P2G + SDF sweep, grid update, G2P over the tables), pass B by
    RK2 midpoint (stage-2 sample), then clamp + pushback. A particle left
    out of table A keeps its own velocity and the midpoint p + dt/2 v; one
    left out of table B keeps its own velocity for the stage-2 step. The
    particles leave in table B's sorted order."""
    dx, shape, cap = cfg.dx, cfg.grid_shape, cfg.bucket_capacity
    solid = state.solid

    # ---------------- PASS A: bucket by position ----------------
    with trace.span("pass_a"):
        table_a = build_buckets(
            state.pos, tuple(state.pos.unbind(dim=1)) + tuple(
                state.vel.unbind(dim=1)), dx, shape, cap)
    with trace.span("liquid_sdf"):
        liquid_phi, p2g_sums = pg.p2g_and_sdf(
            table_a, shape, dx, cfg.particle_radius, solid.center_phi,
            (cfg.u_shape, cfg.v_shape, cfg.w_shape))

    (u, v, w), (su, sv, sw), solver_diag = _grid_update(
        state, liquid_phi, p2g_sums, dt, cfg)

    # ---------------- G2P + advection over table A ----------------
    with trace.span("g2p"):
        new_t = pg.sample_mac_at_table(table_a, u, v, w, dx)
        old_t = pg.sample_mac_at_table(table_a, su, sv, sw, dx)
        own_t = table_a.fields[3:6]
        vel_t = [_pic_flip(cfg, n_, o_, p_)
                 for n_, o_, p_ in zip(new_t, old_t, own_t)]
        # RK2 stage 1: midpoint from the grid velocity
        # (fluidsimulation.cpp:535)
        half = 0.5 * dt
        mid_t = [p + half * n_ for p, n_ in zip(table_a.fields[0:3], new_t)]
        del new_t, old_t

        spx, spy, spz, svx, svy, svz = table_a.sorted
        flat = gather_results(
            table_a, (*vel_t, *mid_t),
            fallbacks=(svx, svy, svz,
                       spx + half * svx, spy + half * svy, spz + half * svz))
        fvel_x, fvel_y, fvel_z, fmx, fmy, fmz = flat
        overflow = table_a.n_overflow
        del table_a, vel_t, mid_t, flat

    # ---------------- PASS B: bucket by midpoint ----------------
    # only the midpoints enter tables; the positions and stage-1
    # velocities ride the sort
    with trace.span("midpoint_sample"):
        table_b = build_buckets(
            torch.stack([fmx, fmy, fmz], dim=1),
            (fmx, fmy, fmz, spx, spy, spz, fvel_x, fvel_y, fvel_z),
            dx, shape, cap, n_table_fields=3)
        inside_m = _inside(*table_b.fields[0:3], shape, dx)
        v2_t = pg.sample_mac_at_table(table_b, u, v, w, dx, inside_m)
        del inside_m
        _, _, _, sbpx, sbpy, sbpz, sbvx, sbvy, sbvz = table_b.sorted
        # overflow falls back to the particle's own (ballistic) velocity
        fv2 = gather_results(table_b, v2_t, fallbacks=(sbvx, sbvy, sbvz))
        fnp = [p + dt * vv for p, vv in zip((sbpx, sbpy, sbpz), fv2)]
        overflow = overflow + table_b.n_overflow
        del table_b, v2_t, fv2

    with trace.span("pushback"):
        pos = _clamp_and_push_back(fnp, solid, cfg)
    new_state = state.replace(
        pos=pos, vel=torch.stack([sbvx, sbvy, sbvz], dim=1), u=u, v=v, w=w)
    return new_state, dict(bucket_overflow=overflow, **solver_diag)


def _step_stream(state: SimState, dt: float, cfg: SimConfig):
    """One CFL substep on the sorted-stream engine: pass A's one sort, P2G
    and SDF as segment reductions, G2P and the stage-2 sample as row
    gathers, then clamp + pushback. No capacity, no overflow; the particles
    leave in pass A's stream order."""
    dx, shape = cfg.dx, cfg.grid_shape
    solid = state.solid

    # ---------------- PASS A: the substep's one sort ----------------
    with trace.span("pass_a"):
        stream = stream_sort(
            state.pos, tuple(state.pos.unbind(dim=1)) + tuple(
                state.vel.unbind(dim=1)), dx, shape)
        spx, spy, spz, svx, svy, svz = stream.sorted
    with trace.span("liquid_sdf"):
        liquid_phi, p2g_sums = st.p2g_sdf_stream(
            stream, shape, dx, cfg.particle_radius, solid.center_phi,
            (cfg.u_shape, cfg.v_shape, cfg.w_shape))

    (u, v, w), (su, sv, sw), solver_diag = _grid_update(
        state, liquid_phi, p2g_sums, dt, cfg)

    # ---------------- G2P + advection ----------------
    # one row gather serves the new and the FLIP-saved fields
    with trace.span("g2p"):
        (nu, ou), (nv, ov), (nw, ow) = st.sample_mac_at(
            spx, spy, spz, stream.key, [u, su], [v, sv], [w, sw], dx, shape)
        vel = [_pic_flip(cfg, n_, o_, p_) for n_, o_, p_ in zip(
            (nu, nv, nw), (ou, ov, ow), (svx, svy, svz))]
        half = 0.5 * dt
        mx = spx + half * nu
        my = spy + half * nv
        mz = spz + half * nw
        del stream, ou, ov, ow

    # ---------------- stage 2 at the midpoints (no re-sort) -------------
    with trace.span("midpoint_sample"):
        key_m = cell_of_position(torch.stack([mx, my, mz], dim=1), dx, shape)
        (v2x,), (v2y,), (v2z,) = st.sample_mac_at(
            mx, my, mz, key_m, [u], [v], [w], dx, shape,
            valid=_inside(mx, my, mz, shape, dx))
        fnp = [p + dt * vv for p, vv in zip((spx, spy, spz), (v2x, v2y, v2z))]

    with trace.span("pushback"):
        pos = _clamp_and_push_back(fnp, solid, cfg)
    new_state = state.replace(pos=pos, vel=torch.stack(vel, dim=1),
                              u=u, v=v, w=w)
    zero = torch.zeros((), dtype=torch.int64, device=state.pos.device)
    return new_state, dict(bucket_overflow=zero, **solver_diag)


def _step_pallas(state: SimState, dt: float, cfg: SimConfig,
                 substep_idx=None):
    """One CFL substep on the tile-major engine: pass A (P2G scatter + SDF
    table, grid update, G2P gather), pass B (stage-2 sample at the RK2
    midpoints), clamp, solid pushback, clamp, under cfg's pallas_pass_a /
    pallas_pass_b / pallas_pushback variants."""
    dx = cfg.dx
    shape = cfg.grid_shape
    solid = state.solid
    cap = cfg.sdf_cap

    # ---------------- PASS A ----------------
    with trace.span("pass_a"):
        pos_a, vel_a, key_a, plan_a, sums, table, overflow = _pass_a(
            state, cfg, substep_idx)
    uncovered = {}   # per visit plan, the particles it left uncovered
    visits = []      # per visit plan, the visits its chunks asked for
    with trace.span("liquid_sdf"):
        liquid_phi = pp.liquid_sdf_from_table(
            table, cap, shape, dx, cfg.particle_radius, solid.center_phi)
    with trace.span("p2g_combine"):
        p2g_sums = pp.p2g_combine(sums, shape,
                                  (cfg.u_shape, cfg.v_shape, cfg.w_shape))
    del sums, table   # gigabytes at 256^3; nothing below reads them

    (u, v, w), (su, sv, sw), solver_diag = _grid_update(
        state, liquid_phi, p2g_sums, dt, cfg)

    # ---------------- G2P + advection ----------------
    with trace.span("g2p"):
        spx, spy, spz = (pos_a[:, a].contiguous() for a in range(3))
        svx, svy, svz = vel_a.unbind(dim=1)
        gu, gv, gw, gsu, gsv, gsw = _gather_grids(cfg, u, v, w, su, sv, sw)
        gm = pp.gather_mac(spx, spy, spz, key_a, [gu, gsu], [gv, gsv],
                           [gw, gsw], dx, shape, cfg.pallas_split_terms)
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
        vel_x = _pic_flip(cfg, nu, ou, svx)
        vel_y = _pic_flip(cfg, nv, ov, svy)
        vel_z = _pic_flip(cfg, nw, ow, svz)

        # RK2 stage 1 midpoint from the grid velocity (fluidsimulation.cpp:535)
        half = 0.5 * dt
        mx = spx + half * nu
        my = spy + half * nv
        mz = spz + half * nw

    # ---------------- PASS B: stage-2 sample at the midpoints ----------------
    with trace.span("midpoint_sample"):
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
        gmb = pp.gather_mac_one_grid(bmx, bmy, bmz, key_m, gu, gv, gw, dx,
                                     shape, cfg.pallas_split_terms)
        inside_m = _inside(bmx, bmy, bmz, shape, dx)
        zero = torch.zeros_like(bmx)
        v2 = [torch.where(inside_m, gmb[c], zero) for c in range(3)]
        if sample_ok is not None:
            v2 = [torch.where(sample_ok, g, bv)
                  for g, bv in zip(v2, (bvx, bvy, bvz))]
        fnp = [p + dt * vv for p, vv in zip((bpx, bpy, bpz), v2)]

    # ---------------- clamp + solid pushback ----------------
    with trace.span("pushback"):
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


def step(state: SimState, dt: float, cfg: SimConfig, substep_idx=None):
    """One CFL substep (the body of the reference's advance loop,
    fluidsimulation.cpp:144-166) on cfg.particle_engine. `dt` is a Python
    float holding an f32 value; `substep_idx` (the advance loop's counter,
    None for 0) sets the "pallas" engine's stale pass-A re-sort cadence.
    Only the "pallas" engine needs a grid of whole 8x8x8 tiles. Returns
    (state, diagnostics pieces)."""
    with trace.span("substep"):
        if cfg.particle_engine == "stream":
            return _step_stream(state, dt, cfg)
        if cfg.particle_engine == "pallas":
            pp.check_grid(cfg.grid_shape)
            return _step_pallas(state, dt, cfg, substep_idx)
        return _step_table(state, dt, cfg)


def advance(state: SimState, dt: float, cfg: SimConfig):
    """Advance by a frame of length dt with CFL substeps
    (fluidsimulation.cpp:135-168). Returns (state, StepDiagnostics). Every
    read from the device goes through trace.read: one CFL read a substep
    (site "cfl_read"), the step's own, and the frame's diagnostics at its
    end (sites "frame.*"); StepDiagnostics.host_reads holds the frame's
    counts by site and, while a profiler records, .stages its spans."""
    f32 = np.float32
    read = trace.read
    dt = f32(dt)
    t = f32(0.0)
    diag = StepDiagnostics()
    counts = {k: [] for k in _COUNTED}
    visits = []
    with trace.Frame(state.pos.is_cuda) as frame:
        while t < dt and diag.substeps < cfg.max_substeps:
            maxvel = f32(read("cfl_read",
                              _max_velocity(state.u, state.v, state.w)))
            cfl = f32(cfg.cfl_number * cfg.dx) / maxvel if maxvel > 0 \
                else f32(np.inf)
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
            diag.viscosity_solves += d["viscosity_solves"]
            diag.viscosity_unconverged += d["viscosity_unconverged"]
            diag.max_velocity = max(diag.max_velocity, float(maxvel))
            diag.liquid_cells = d["liquid_cells"]
            for k, v in counts.items():
                v.append(d.get(k, 0))
            visits.append(d.get("plan_visits", 0))
            t = f32(t + substep)
        with trace.span("frame_reads"):
            diag.pressure_residual = float(
                read("frame.pressure", diag.pressure_residual))
            diag.pressure_tolerance = float(
                read("frame.pressure", diag.pressure_tolerance))
            diag.viscosity_residual = float(
                read("frame.viscosity", diag.viscosity_residual))
            diag.viscosity_tolerance = float(
                read("frame.viscosity", diag.viscosity_tolerance))
            diag.liquid_cells = int(
                read("frame.liquid_cells", diag.liquid_cells))
            for k, v in counts.items():
                setattr(diag, k,
                        int(sum(int(read("frame.counts", o)) for o in v)))
            diag.plan_demand = max(
                (int(read("frame.plan_visits", o)) for o in visits),
                default=0) / pp.n_chunks(state.pos.shape[0])
    diag.stages, diag.host_reads = frame.stages, frame.host_reads
    return state, diag
