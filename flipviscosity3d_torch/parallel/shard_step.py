"""The FLIP substep over an explicit i-axis slab decomposition: halo exchange,
owner-based particle migration, slab multigrid and CG with global
reductions.

Counterpart of flipviscosity3d_tpu/parallel/shard_step.py on the port's
slab groups (parallel/collectives.py): each rank of a group runs the
slab-local substep on its own slab (a LocalGroup runs them as threads on one
device, a DistGroup as processes), and every collective is a visible call:

- halo exchange (parallel/halo.py) before shifted reads: the stencils, the
  extrapolation layers, the particles' sampling windows;
- halo reduce after a scatter: P2G sums and particle-SDF mins fold onto
  their owners;
- psum / pmax inside CG (solvers/pcg.py `group`, `reduce_mask`), the CFL
  velocity, the tolerances and the viscosity switch: every rank reads the
  same reduced values, so every host loop and branch goes the same way;
- ppermute of fixed-capacity migration buffers moves particles whose home
  cell left the slab (at most one slab a substep: the CFL displacement is
  below the slab width).

Layout (as the JAX package's):
- every cell-extent slab holds the global rows [s*B - H, s*B + B + H)
  (B = I / n, H the halo); node-extent slabs hold one more row;
- the u grid is stored CROPPED to I rows: the global face row I is solid at
  the domain boundary and every output there is zero, so u slabs are
  shaped like cell slabs and no face is counted twice in a reduction.

Two particle engines, by cfg.particle_engine: "stream" (the JAX default for
slabs: a local sort, segment reductions, row gathers) and "pallas" (the
local tile-key sort, then the pass-A plan and K5
scatter_p2g_table_stale, K2 gather_mac of two grids at the particles, the
midpoint plan and K2 gather_mac_one_grid at the midpoints, on every slab).
The JAX package's TPU column layout (build_mac_columns, gather_payload) has
no place here: K2 gathers from the grids.

Two faults of the JAX module are not copied: its pass-A uncovered count
subtracts the dead rows from all uncovered ones (:343-346), where the port
counts (~covered) & alive; and its slab gather ignores
pallas_gather_dtype (:547), which the port's honours as its single-device
step does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SimConfig
from ..core.state import SimState, StepDiagnostics
from ..core.step import _clamp_bounds, _gather_grids, _pic_flip
from ..ops import pallas_particles as pp
from ..ops import stream_transfers as st
from ..ops.extrapolate import extrapolate_grid
from ..ops.grids import (face_borders_fluid_v, face_borders_fluid_w,
                         shifted_read)
from ..ops.levelset import fraction_inside
from ..ops.stream import stream_sort_keys
from ..solvers import pressure as psolver
from ..solvers import viscosity as vsolver
from ..solvers.pcg import jacobi_preconditioner, pcg
from . import halo
from .collectives import ring
from .slab_mg import (slab_pressure_mg_preconditioner,
                      slab_viscosity_mg_preconditioner)

_F32 = np.float32
_IMAX = torch.iinfo(torch.int32).max
_P2G_EPS = 1e-9
# the per-substep counts psum'd in one collective, in this order
_SUMMED = ("bucket_overflow", "liquid_cells", "uncovered_pass_a",
           "uncovered_pass_b", "migrated", "migration_lost")
_STATIC = ("solid_center", "solid_phi", "weight_u", "weight_v", "weight_w",
           "solid_u", "solid_v", "solid_w", "viscosity")


@dataclasses.dataclass
class ShardedSim:
    """The slabs this process holds; every tensor but gravity leads with the
    slab axis (one entry per rank in `ranks`, the global slab index)."""

    pos: torch.Tensor           # (n, cap, 3)
    vel: torch.Tensor           # (n, cap, 3)
    alive: torch.Tensor         # (n, cap) bool
    u: torch.Tensor             # (n, B+2H, J, K)   cropped faces
    v: torch.Tensor             # (n, B+2H, J+1, K)
    w: torch.Tensor             # (n, B+2H, J, K+1)
    solid_center: torch.Tensor  # (n, B+2H, J, K)
    solid_phi: torch.Tensor     # (n, B+2H+1, J+1, K+1)
    weight_u: torch.Tensor      # cropped faces, like u
    weight_v: torch.Tensor
    weight_w: torch.Tensor
    solid_u: torch.Tensor       # bool face states, like u / v / w
    solid_v: torch.Tensor
    solid_w: torch.Tensor
    viscosity: torch.Tensor     # (n, B+2H+1, J+1, K+1)
    gravity: torch.Tensor       # (3,)
    ranks: tuple = ()

    def replace(self, **changes) -> "ShardedSim":
        return dataclasses.replace(self, **changes)


class SlabSpec(NamedTuple):
    n: int
    B: int
    H: int
    cap: int      # particles per slab
    mig: int      # migration buffer rows per direction


@dataclasses.dataclass
class ShardDiagnostics(StepDiagnostics):
    """A sharded frame's StepDiagnostics, the same on every rank, plus what
    the slabs did: particles handed to a neighbour slab, those of them
    dropped at a full migration buffer (counted in bucket_overflow too),
    and per slab of this process its uncovered particle-substeps under the
    pass-A and the midpoint plans ("pallas")."""

    migrated: int = 0
    migration_lost: int = 0
    slab_uncovered: tuple = ()


def make_spec(cfg: SimConfig, n: int, halo_width: int = 6,
              cap_factor: float = 2.0, n_particles: int = 0,
              mig: int | None = None) -> SlabSpec:
    """`mig` overrides the per-direction migration-buffer rows (default
    max(256, per_slab / 4)); size it above the worst per-substep face
    crossing of the scene: overflow drops particles (counted in
    bucket_overflow), it never corrupts stayers.

    With cfg.particle_engine "pallas" the default halo widens from 6 to 8,
    so that the local slab extent B + 2H stays a multiple of the engine's
    8^3 tile (an explicit tile-multiple halo_width overrides it)."""
    if cfg.particle_engine == "pallas" and halo_width == 6:
        halo_width = 8
    if cfg.isize % n:
        raise ValueError(f"isize {cfg.isize} not divisible by {n} shards")
    b = cfg.isize // n
    if b < halo_width:
        raise ValueError(f"slab width {b} < halo {halo_width}")
    if b <= cfg.cfl_number:
        raise ValueError(
            f"slab width {b} <= CFL {cfg.cfl_number}: migration assumes "
            "at most one-shard moves per substep")
    if halo_width < cfg.cfl_number + 1:
        raise ValueError(
            f"halo width {halo_width} < cfl_number + 1 "
            f"({cfg.cfl_number + 1:g}): advected/midpoint positions could "
            "leave the slab halo and the RK2/pushback stencils would "
            "silently sample clamped (wrong) cells")
    per = int(np.ceil(n_particles / n))
    if mig is None:
        mig = max(256, per // 4)
    cap = int(np.ceil(per * cap_factor / 8) * 8) + 2 * mig
    return SlabSpec(n, b, int(halo_width), cap, int(mig))


# --------------------------------------------------------------------------
# set-up: global state -> slabs, and back (host side)
# --------------------------------------------------------------------------

def _slab_rows(g: np.ndarray, spec: SlabSpec, node: bool, fill) -> np.ndarray:
    """(n, B+2H(+1), ...) slabs of a global cell- or node-extent array."""
    h, b, n = spec.H, spec.B, spec.n
    pad = np.full((h,) + g.shape[1:], fill, g.dtype)
    padded = np.concatenate([pad, g, pad], axis=0)
    rows = b + 2 * h + (1 if node else 0)
    return np.stack([padded[s * b:s * b + rows] for s in range(n)])


def shard_simstate(state: SimState, cfg: SimConfig, spec: SlabSpec,
                   group=None) -> ShardedSim:
    """Cut a global SimState into slabs and per-slab particle arrays, on the
    state's device. A group keeps the slabs of the ranks it drives (a
    DistGroup's one); None keeps all."""
    host = lambda t: t.detach().cpu().numpy()   # noqa: E731
    pos, vel = host(state.pos), host(state.vel)
    owner = np.clip(np.floor(pos[:, 0] / cfg.dx).astype(np.int64) // spec.B,
                    0, spec.n - 1)
    ppos = np.zeros((spec.n, spec.cap, 3), np.float32)
    pvel = np.zeros((spec.n, spec.cap, 3), np.float32)
    alive = np.zeros((spec.n, spec.cap), bool)
    for s in range(spec.n):
        idx = np.nonzero(owner == s)[0]
        if len(idx) > spec.cap:
            raise ValueError(
                f"shard {s} seeded {len(idx)} > capacity {spec.cap}")
        ppos[s, :len(idx)] = pos[idx]
        pvel[s, :len(idx)] = vel[idx]
        alive[s, :len(idx)] = True

    ranks = tuple(range(spec.n)) if group is None else tuple(
        r.rank for r in group.ranks)
    dev = state.pos.device
    keep = list(ranks)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[keep])).to(dev)

    solid = state.solid
    cell = lambda g, fill=0.0: put(_slab_rows(host(g), spec, False, fill))  # noqa: E731,E501
    node = lambda g, fill=0.0: put(_slab_rows(host(g), spec, True, fill))   # noqa: E731,E501
    face_u = lambda g, fill=0.0: put(_slab_rows(host(g)[:-1], spec, False, fill))  # noqa: E731,E501
    return ShardedSim(
        pos=put(ppos), vel=put(pvel), alive=put(alive),
        u=face_u(state.u), v=cell(state.v), w=cell(state.w),
        solid_center=cell(solid.center_phi, fill=1.0),
        solid_phi=node(solid.phi, fill=1.0),
        weight_u=face_u(solid.weight_u), weight_v=cell(solid.weight_v),
        weight_w=cell(solid.weight_w),
        solid_u=face_u(solid.solid_u, fill=True),
        solid_v=cell(solid.solid_v, fill=True),
        solid_w=cell(solid.solid_w, fill=True),
        viscosity=node(state.viscosity), gravity=state.gravity.clone(),
        ranks=ranks)


def gather_particles(ss: ShardedSim):
    """(N, 3) positions and velocities (numpy) of the alive particles of the
    slabs `ss` holds."""
    alive = ss.alive.cpu().numpy().reshape(-1)
    pos = ss.pos.cpu().numpy().reshape(-1, 3)[alive]
    vel = ss.vel.cpu().numpy().reshape(-1, 3)[alive]
    return pos, vel


def gather_grid_u(ss: ShardedSim, spec: SlabSpec):
    """The global (I+1, J, K) u grid (numpy) from all n slabs, the cropped
    face row as 0."""
    full = gather_grid_cell(ss.u, spec)
    return np.concatenate([full, np.zeros((1,) + full.shape[1:],
                                          full.dtype)], axis=0)


def gather_grid_cell(a, spec: SlabSpec):
    """The owned rows of (n, B+2H, ...) slabs, stacked into (n*B, ...)."""
    owned = a.cpu().numpy()[:, spec.H:spec.H + spec.B]
    return owned.reshape(-1, *owned.shape[2:])


# --------------------------------------------------------------------------
# slab-local masks
# --------------------------------------------------------------------------

def _rows_index(rows: int, device):
    return torch.arange(rows, device=device).reshape(rows, 1, 1)


def _owned_rows(rows: int, spec: SlabSpec, device):
    """(rows, 1, 1) bool: the slab's owned rows."""
    r = _rows_index(rows, device)
    return (r >= spec.H) & (r < spec.H + spec.B)


def _i_range_mask(rows: int, lo: int, hi: int, spec: SlabSpec, rank: int,
                  device):
    """lo <= global i < hi as a (rows, 1, 1) bool."""
    g = rank * spec.B - spec.H + _rows_index(rows, device)
    return (g >= lo) & (g < hi)


def _jk_range_mask(shape, lo, hi, device):
    m = torch.zeros(tuple(shape[1:]), dtype=torch.bool, device=device)
    m[lo[0]:hi[0], lo[1]:hi[1]] = True
    return m[None]


def _local_keys(px, py, pz, alive, dx, local_shape):
    """i-major local cell key per particle from slab-local coordinates;
    dead -> n_cells (sorts last, belongs to no run)."""
    ijk = [torch.floor(p / dx).to(torch.int32).clamp(0, n - 1).long()
           for p, n in zip((px, py, pz), local_shape)]
    key = (ijk[0] * local_shape[1] + ijk[1]) * local_shape[2] + ijk[2]
    n_cells = local_shape[0] * local_shape[1] * local_shape[2]
    return torch.where(alive, key, torch.full_like(key, n_cells))


# --------------------------------------------------------------------------
# the slab substep
# --------------------------------------------------------------------------

def slab_origin(rank: int, spec: SlabSpec, dx: float):
    """The x of a slab's first (halo) row, in f32: the particles of the
    slab substep run in x less this."""
    return _F32(_F32(rank * spec.B - spec.H) * _F32(dx))


def slab_stream(px, py, pz, vx, vy, vz, alive, cfg, local_shape):
    """The "pallas" engine's particle stream on a slab: the local tile-key
    sort (dead rows keyed _IMAX sort last and no plan covers them) and the
    pass-A plan -> (sorted fields, alive, key, plan)."""
    key_raw = torch.where(
        alive, pp.key_of_position(torch.stack([px, py, pz], dim=1), cfg.dx,
                                  local_shape),
        torch.full_like(px, _IMAX, dtype=torch.int32))
    key, perm = torch.sort(key_raw, stable=True)
    fields = [f[perm] for f in (px, py, pz, vx, vy, vz)]
    plan = pp.plan_pass_a(key, local_shape, cfg.pallas_passa_budget,
                          cfg.pallas_passa_factor)
    return fields, alive[perm], key, plan


def _pass_a_pallas(px, py, pz, vx, vy, vz, alive, cfg, local_shape,
                   face_shapes, solid_center):
    """The "pallas" engine's pass A on a slab: slab_stream, then K5 ->
    (sorted fields, alive, key, plan, liquid_phi before its solid
    extrapolation, P2G sums, the table's and the plan's drops)."""
    dx, cap = cfg.dx, cfg.sdf_cap
    fields, salive, key, plan = slab_stream(px, py, pz, vx, vy, vz, alive,
                                            cfg, local_shape)
    sums, table, counts = pp.scatter_p2g_table_stale(
        torch.stack(fields[0:3], dim=1), torch.stack(fields[3:6], dim=1),
        key, plan, local_shape, dx, cap, terms=cfg.pallas_split_terms)
    liquid_phi = pp.liquid_sdf_from_table(
        table, cap, local_shape, dx, cfg.particle_radius, solid_center,
        finalize=False)
    p2g_sums = pp.p2g_combine(sums, local_shape, face_shapes)
    uncovered = ((~plan.covered) & salive).sum()
    return (fields, salive, key, plan, liquid_phi, p2g_sums,
            pp.table_rank_overflow(counts, cap), uncovered)


def _substep(pos, vel, alive, u, v, w, static, dt: float, cfg: SimConfig,
             spec: SlabSpec, group):
    """One CFL substep on this rank's slabs -> (pos, vel, alive, u, v, w,
    per-substep counts: {name: 0-d tensor} of _SUMMED before the psum, and
    the pressure / viscosity results)."""
    (solid_center, solid_phi, weight_u, weight_v, weight_w,
     solid_u, solid_v, solid_w, viscosity, gravity) = static
    dx = cfg.dx
    h = spec.H
    dev = pos.device
    rank = group.rank
    rows = spec.B + 2 * h
    local_shape = (rows, cfg.jsize, cfg.ksize)
    face_shapes = (local_shape, (rows, cfg.jsize + 1, cfg.ksize),
                   (rows, cfg.jsize, cfg.ksize + 1))
    n_cells = rows * cfg.jsize * cfg.ksize
    exch = lambda xs, fills=None: halo.halo_exchange_many(  # noqa: E731
        xs, group, h, fills or [0.0] * len(xs))

    # The particles run in SLAB-LOCAL x (shifted by the slab origin), so that
    # local cell indices, home cells and trilinear fractions agree with the
    # slabs; y and z are global.
    x_origin = slab_origin(rank, spec, dx)
    px = pos[:, 0] - float(x_origin)
    py, pz = pos[:, 1], pos[:, 2]
    vx, vy, vz = vel[:, 0], vel[:, 1], vel[:, 2]
    max_dist = float(_F32(3.0 * dx))
    use_pallas = cfg.particle_engine == "pallas"
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    counts = dict.fromkeys(_SUMMED, zero_i)

    # ---------------- pass A ----------------
    if use_pallas:
        pp.check_grid(local_shape)
        (fields, salive, key_a, plan_a, liquid_phi, p2g_sums, table_drops,
         uncovered_a) = _pass_a_pallas(px, py, pz, vx, vy, vz, alive, cfg,
                                       local_shape, face_shapes,
                                       solid_center)
        spx, spy, spz, svx, svy, svz = fields
        counts["uncovered_pass_a"] = uncovered_a
        overflow = table_drops + uncovered_a
    else:
        stream = stream_sort_keys(
            _local_keys(px, py, pz, alive, dx, local_shape),
            (px, py, pz, vx, vy, vz, alive), local_shape)
        spx, spy, spz, svx, svy, svz, salive = stream.sorted
        liquid_phi, p2g_sums = st.p2g_sdf_stream(
            stream, local_shape, dx, cfg.particle_radius, solid_center,
            face_shapes, finalize=False)
        key_a = stream.key.clamp(max=n_cells - 1)   # dead rows: any cell
        overflow = zero_i
    # fold the scatters' halo rows onto their owners, refresh the halos
    flat = [liquid_phi] + [g for pair in p2g_sums for g in pair]
    flat = halo.halo_reduce_many(flat, group, h, ["min"] + ["sum"] * 6,
                                 [max_dist] + [0.0] * 6)
    flat = exch(flat, [max_dist] + [0.0] * 6)
    liquid_phi = st.extrapolate_sdf_into_solid(flat[0], solid_center, dx)
    p2g_sums = [(flat[1 + 2 * c], flat[2 + 2 * c]) for c in range(3)]
    fluid = liquid_phi < 0

    # ---------------- grid update ----------------
    # u is cropped, so its rows align with the cells
    borders = (fluid | F.pad(fluid[:-1], (0, 0, 0, 0, 1, 0)),
               face_borders_fluid_v(fluid), face_borders_fluid_w(fluid))
    vel_g, valid = [], []
    for (vsum, wsum), b in zip(p2g_sums, borders):
        mask = (wsum >= _P2G_EPS) & b
        vals = vsum / torch.clamp(wsum, min=_P2G_EPS)
        vel_g.append(torch.where(mask, vals, torch.zeros_like(vals)))
        valid.append(mask)

    big_i = cfg.isize
    # interior global i ranges: u faces [1, I) (cropped), v / w cells
    # [1, I - 1); j / k interiors of the arrays
    i_hi = (big_i, big_i - 1, big_i - 1)
    interiors = [
        _i_range_mask(rows, 1, hi, spec, rank, dev)
        & _jk_range_mask(fs, (1, 1), (fs[1] - 1, fs[2] - 1), dev)
        for fs, hi in zip(face_shapes, i_hi)]

    def ex_gv(g, v):
        g, vf = exch([g, v.to(torch.float32)])
        return g, vf > 0.5

    def extrapolate(grids, masks):
        out = [extrapolate_grid(g, m, cfg.extrapolation_layers,
                                interior=it, exchange=ex_gv)
               for g, m, it in zip(grids, masks, interiors)]
        flat = exch([t for g, m in out for t in (g, m.to(torch.float32))])
        return ([flat[2 * c] for c in range(3)],
                [flat[2 * c + 1] > 0.5 for c in range(3)])

    vel_g, _ = extrapolate(vel_g, valid)
    saved = list(vel_g)   # the FLIP baseline
    vel_g = [torch.where(b, g + gravity[a] * dt, g)
             for a, (g, b) in enumerate(zip(vel_g, borders))]

    # ---------------- viscosity ----------------
    owned = _owned_rows(rows, spec, dev)
    visc_iters, visc_res, visc_tol = 0, zero_i.float(), zero_i.float()
    visc_solves = visc_unconverged = 0
    # the switch must be the same on every rank (collectives inside)
    if bool(group.pmax(viscosity.max()) > 0):
        volumes = vsolver.compute_volume_grids(liquid_phi, cfg)
        # the reference's row ranges, i, j, k in [1, size), in global i
        row_masks = tuple(
            _i_range_mask(rows, 1, big_i, spec, rank, dev)
            & _jk_range_mask(fs, (1, 1), (cfg.jsize, cfg.ksize), dev)
            for fs in face_shapes)
        vsys = vsolver.build_viscosity_system(
            *vel_g, volumes, vsolver.FaceStates(solid_u, solid_v, solid_w),
            viscosity, dt, cfg, row_masks=row_masks)
        warm = tuple(torch.where(m, g, torch.zeros_like(g))
                     for m, g in zip(vsys.in_mat, vel_g))
        bnorm = group.pmax(torch.stack([
            (r.abs() * owned).max() for r in vsys.rhs]).max())
        visc_tol = float(_F32(cfg.viscosity_solve_rtol)) * bnorm
        if cfg.viscosity_preconditioner == "multigrid":
            precon = slab_viscosity_mg_preconditioner(vsys, spec, cfg, group)
        else:
            precon = jacobi_preconditioner(vsys.diag)
        result = pcg(
            lambda x: vsolver.apply_viscosity_matrix(vsys, tuple(exch(x))),
            vsys.rhs, vsolver.spanned_preconditioner(precon), visc_tol,
            cfg.viscosity_solve_max_iterations, x0=warm, group=group,
            reduce_mask=(owned,) * 3)
        if result.converged or float(result.residual) < \
                cfg.viscosity_acceptable_error:
            vel_g = [torch.where(m, x, torch.zeros_like(x))
                     for m, x in zip(vsys.in_mat, result.x)]
        vel_g = exch(vel_g)
        visc_iters, visc_res = result.iterations, result.residual
        visc_solves, visc_unconverged = 1, int(not result.converged)
        del vsys, volumes, precon, result

    # ---------------- pressure ----------------
    interior_p = (_i_range_mask(rows, 1, big_i - 1, spec, rank, dev)
                  & _jk_range_mask(local_shape, (1, 1),
                                   (cfg.jsize - 1, cfg.ksize - 1), dev))
    psys = _build_pressure_slab(*vel_g, liquid_phi, weight_u, weight_v,
                                weight_w, dt, cfg, interior_p)
    bnorm = group.pmax((psys.b.abs() * owned).max())
    ptol = torch.maximum(
        torch.tensor(cfg.pressure_solve_tolerance, dtype=torch.float32,
                     device=dev),
        float(_F32(cfg.pressure_solve_rtol)) * bnorm)
    if cfg.pressure_preconditioner == "multigrid":
        p_precon = slab_pressure_mg_preconditioner(psys, spec, cfg, group)
    else:
        p_precon = jacobi_preconditioner((psys.diag,))
    pres = pcg(
        lambda x: (psolver.apply_pressure_matrix(psys, exch([x[0]])[0]),),
        (psys.b,), p_precon, ptol, cfg.pressure_solve_max_iterations,
        group=group, reduce_mask=(owned,))
    pressure = exch([pres.x[0]])[0]
    del psys, p_precon
    *vel_g, vu, vv, vw = _apply_pressure_slab(
        *vel_g, pressure, liquid_phi, weight_u, weight_v, weight_w, dt, cfg,
        spec, rank)
    vel_g, _ = extrapolate(vel_g, (vu, vv, vw))

    # constrain (fluidsimulation.cpp:696-729), both fields
    weights = (weight_u, weight_v, weight_w)
    u, v, w = (torch.where(wt == 0, torch.zeros_like(g), g)
               for g, wt in zip(vel_g, weights))
    su, sv, sw = (torch.where(wt == 0, torch.zeros_like(g), g)
                  for g, wt in zip(saved, weights))

    # ---------------- G2P + advection ----------------
    gu, gv, gw, gsu, gsv, gsw = _gather_grids(cfg, u, v, w, su, sv, sw)
    if use_pallas:
        # the kernel reads whole face grids: the cropped u row as zeros
        gu, gsu = (F.pad(g, (0, 0, 0, 0, 0, 1)) for g in (gu, gsu))
        gm = pp.gather_mac(spx, spy, spz, key_a, [gu, gsu], [gv, gsv],
                           [gw, gsw], dx, local_shape,
                           cfg.pallas_split_terms)
        nu, nv, nw, ou, ov, ow = gm.unbind(dim=0)
        # uncovered particles advect ballistically: new == old == own
        cov = plan_a.covered
        nu, ou = (torch.where(cov, g, svx) for g in (nu, ou))
        nv, ov = (torch.where(cov, g, svy) for g in (nv, ov))
        nw, ow = (torch.where(cov, g, svz) for g in (nw, ow))
    else:
        (nu, ou), (nv, ov), (nw, ow) = st.sample_mac_at(
            spx, spy, spz, key_a, [gu, gsu], [gv, gsv], [gw, gsw], dx,
            local_shape)
    vel_x = _pic_flip(cfg, nu, ou, svx)
    vel_y = _pic_flip(cfg, nv, ov, svy)
    vel_z = _pic_flip(cfg, nw, ow, svz)

    half = 0.5 * dt
    mx, my, mz = spx + half * nu, spy + half * nv, spz + half * nw
    xo = float(x_origin)
    inside_m = ((mx + xo >= 0) & (mx + xo < float(_F32(cfg.isize * dx)))
                & (my >= 0) & (my < float(_F32(cfg.jsize * dx)))
                & (mz >= 0) & (mz < float(_F32(cfg.ksize * dx))))
    if use_pallas:
        key_m = torch.where(
            salive, pp.key_of_position(torch.stack([mx, my, mz], dim=1), dx,
                                       local_shape),
            torch.full_like(key_a, _IMAX))
        plan_m = pp.plan_midpoint_visits(key_m, cfg.pallas_midpoint_budget,
                                         cfg.pallas_midpoint_factor)
        gmb = pp.gather_mac_one_grid(mx, my, mz, key_m, gu, gv, gw, dx,
                                     local_shape, cfg.pallas_split_terms)
        # outside-domain midpoints sample 0; uncovered particles advect
        # ballistically (core/step._step_pallas's order)
        covm = plan_m.covered
        v2 = [torch.where(covm, torch.where(inside_m, gmb[c],
                                            torch.zeros_like(mx)), bv)
              for c, bv in enumerate((vel_x, vel_y, vel_z))]
        uncovered_b = ((~covm) & salive).sum()
        counts["uncovered_pass_b"] = uncovered_b
        overflow = overflow + uncovered_b
    else:
        key_m = _local_keys(mx, my, mz, salive, dx, local_shape)
        (v2x,), (v2y,), (v2z,) = st.sample_mac_at(
            mx, my, mz, key_m.clamp(max=n_cells - 1), [gu], [gv], [gw], dx,
            local_shape, valid=inside_m)
        v2 = [v2x, v2y, v2z]
    npx, npy, npz = (p + dt * vv for p, vv in zip((spx, spy, spz), v2))

    # ---------------- clamp + solid pushback ----------------
    lo, his = _clamp_bounds(cfg)
    lo_x = float(_F32(lo) - x_origin)
    hi_x = float(_F32(his[0]) - x_origin)
    cpx = torch.clamp(npx, lo_x, hi_x)
    cpy = torch.clamp(npy, lo, his[1])
    cpz = torch.clamp(npz, lo, his[2])
    key_c = _local_keys(cpx, cpy, cpz, salive, dx, local_shape)
    dpx, dpy, dpz = st.solid_pushback_at(
        cpx, cpy, cpz, key_c.clamp(max=n_cells - 1), solid_phi, dx,
        local_shape)
    fx = torch.clamp(cpx + dpx, lo_x, hi_x)
    fy = torch.clamp(cpy + dpy, lo, his[1])
    fz = torch.clamp(cpz + dpz, lo, his[2])

    # ---------------- migration (global x again) ----------------
    new_pos, new_vel, new_alive, sent, lost = _migrate(
        fx + xo, fy, fz, vel_x, vel_y, vel_z, salive, dx, spec, group)
    counts.update(
        bucket_overflow=overflow + lost,
        liquid_cells=(fluid & owned).sum(),
        migrated=torch.tensor(sent, device=dev),
        migration_lost=torch.tensor(lost, device=dev))
    solves = dict(pressure_iterations=pres.iterations,
                  pressure_residual=pres.residual, pressure_tolerance=ptol,
                  viscosity_iterations=visc_iters,
                  viscosity_residual=visc_res,
                  viscosity_tolerance=visc_tol,
                  viscosity_solves=visc_solves,
                  viscosity_unconverged=visc_unconverged)
    return new_pos, new_vel, new_alive, u, v, w, counts, solves


def _build_pressure_slab(u, v, w, liquid_phi, weight_u, weight_v, weight_w,
                         dt, cfg, interior):
    """solvers.pressure.build_pressure_system on cropped-u slabs: face i+1
    of cell row r is u row r+1."""
    shape = tuple(liquid_phi.shape)
    fluid = (liquid_phi < 0) & interior
    fluid_f = fluid.to(torch.float32)

    def up_u(a):   # the value at face i+1 of cell r == row r+1 (cropped)
        return F.pad(a[1:], (0, 0, 0, 0, 0, 1))

    div = (
        weight_u * u - up_u(weight_u) * up_u(u)
        + weight_v[:, :-1] * v[:, :-1] - weight_v[:, 1:] * v[:, 1:]
        + weight_w[:, :, :-1] * w[:, :, :-1]
        - weight_w[:, :, 1:] * w[:, :, 1:]
    ) / cfg.dx
    b = div * fluid_f

    scale = float(_F32(dt) / _F32(cfg.dx * cfg.dx))
    fw_u, fw_v, fw_w = _liquid_face_weights_slab(liquid_phi)
    # clamp AFTER any shift: a zero-filled shifted theta would divide to inf
    # on the outermost halo row, and inf * 0 masking gives NaN
    th = lambda f: torch.clamp(f, min=cfg.minfrac)   # noqa: E731
    theta_u, theta_v, theta_w = th(fw_u), th(fw_v), th(fw_w)

    diag = torch.zeros(shape, dtype=torch.float32, device=u.device)
    zero = torch.zeros_like(diag)
    plus = {}
    specs = [
        (0, +1, up_u(weight_u), th(up_u(fw_u))),
        (0, -1, weight_u, theta_u),
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
    return psolver.PressureSystem(fluid, diag, plus[0], plus[1], plus[2], b,
                                  theta_u, theta_v, theta_w)


def _liquid_face_weights_slab(liquid_phi):
    """liquid_face_weights with cropped-u rows: fw_u row r is the fraction
    at the face between cells r-1 and r (the solvers' row ranges mask the
    global boundary faces, so the edge value is never read)."""
    fw_u = fraction_inside(torch.cat([liquid_phi[:1], liquid_phi[:-1]]),
                           liquid_phi)
    fw_v = F.pad(fraction_inside(liquid_phi[:, :-1], liquid_phi[:, 1:]),
                 (0, 0, 1, 1))
    fw_w = F.pad(fraction_inside(liquid_phi[:, :, :-1], liquid_phi[:, :, 1:]),
                 (1, 1))
    return fw_u, fw_v, fw_w


def _apply_pressure_slab(u, v, w, pressure, liquid_phi, weight_u, weight_v,
                         weight_w, dt, cfg, spec: SlabSpec, rank: int):
    """solvers.pressure.apply_pressure on cropped-u slabs with global
    interiors -> (u, v, w, valid_u, valid_v, valid_w)."""
    dx = cfg.dx
    dev = u.device
    fluid = liquid_phi < 0
    fw_u, fw_v, fw_w = _liquid_face_weights_slab(liquid_phi)

    borders_u = fluid | F.pad(fluid[:-1], (0, 0, 0, 0, 1, 0))
    iu = _i_range_mask(u.shape[0], 1, cfg.isize, spec, rank, dev)
    theta = torch.clamp(fw_u, min=cfg.minfrac)
    grad = pressure - torch.cat([pressure[:1], pressure[:-1]])
    mask_u = iu & (weight_u > 0) & borders_u
    u_new = torch.where(mask_u, u - dt * grad / (dx * theta),
                        torch.zeros_like(u))

    jv = _jk_range_mask(v.shape, (1, 0), (cfg.jsize, cfg.ksize + 1), dev)
    theta = torch.clamp(fw_v, min=cfg.minfrac)
    grad = F.pad(pressure[:, 1:] - pressure[:, :-1], (0, 0, 1, 1))
    mask_v = jv & (weight_v > 0) & face_borders_fluid_v(fluid)
    v_new = torch.where(mask_v, v - dt * grad / (dx * theta),
                        torch.zeros_like(v))

    jw = _jk_range_mask(w.shape, (0, 1), (cfg.jsize + 1, cfg.ksize), dev)
    theta = torch.clamp(fw_w, min=cfg.minfrac)
    grad = F.pad(pressure[:, :, 1:] - pressure[:, :, :-1], (1, 1))
    mask_w = jw & (weight_w > 0) & face_borders_fluid_w(fluid)
    w_new = torch.where(mask_w, w - dt * grad / (dx * theta),
                        torch.zeros_like(w))
    return u_new, v_new, w_new, mask_u, mask_v, mask_w


def _migrate(px, py, pz, vx, vy, vz, alive, dx, spec: SlabSpec, group):
    """Owner-based particle exchange: particles whose home cell moved into a
    neighbour slab travel there in fixed-capacity buffers -> (pos, vel,
    alive, particles sent, particles dropped)."""
    n_rows = px.shape[0]
    m = spec.mig
    dev = px.device
    gi = torch.floor(px / dx).to(torch.int32)
    owner = torch.clamp(torch.div(gi, spec.B, rounding_mode="floor"), 0,
                        spec.n - 1)
    shift = torch.clamp(owner - group.rank, -1, 1)
    # categories: 0 left, 1 stay, 2 right, 3 dead
    cat = torch.where(alive, shift + 1, torch.full_like(shift, 3))
    cat_s, perm = torch.sort(cat, stable=True)
    fields = torch.stack([px, py, pz, vx, vy, vz], dim=1)[perm]   # (n, 6)
    n_l, n_s, n_r = torch.stack(
        [(cat_s == c).sum() for c in range(3)]).tolist()

    padded = torch.cat([fields, fields.new_zeros((m, 6))])
    idx_m = torch.arange(m, device=dev)
    left_buf = padded[:m]
    right_buf = padded[n_l + n_s:n_l + n_s + m]
    left_valid = (idx_m < min(n_l, m)).to(torch.int32)
    right_valid = (idx_m < min(n_r, m)).to(torch.int32)
    lost = max(n_l - m, 0) + max(n_r - m, 0)

    n = spec.n
    from_right_buf, from_right_valid, from_left_buf, from_left_valid = \
        group.ppermute_many([(left_buf, ring(n, -1)),
                             (left_valid, ring(n, -1)),
                             (right_buf, ring(n, +1)),
                             (right_valid, ring(n, +1))])

    # stayers to the front: rotate the sorted rows left by n_l
    stay = torch.roll(fields, -n_l, dims=0)
    idx = torch.arange(n_rows, device=dev)
    # arrivals go to rows [n_s, n_s + 2m) of a copy padded by 2m rows, so a
    # full slab drops the excess arrivals (counted) and never overwrites a
    # stayer
    arrivals = torch.cat([from_left_buf, from_right_buf])
    arr_valid = torch.cat([from_left_valid, from_right_valid]) > 0
    out = torch.cat([stay, stay.new_zeros((2 * m, 6))])
    out[n_s:n_s + 2 * m] = arrivals
    out = out[:n_rows]
    arr_alive = (idx >= n_s) & (idx < n_s + 2 * m)
    alive_out = torch.where(
        arr_alive, arr_valid[torch.clamp(idx - n_s, 0, 2 * m - 1)],
        idx < n_s)
    dropped = int((arr_valid & (n_s + torch.arange(2 * m, device=dev)
                                >= n_rows)).sum())
    return (out[:, :3].contiguous(), out[:, 3:].contiguous(), alive_out,
            min(n_l, m) + min(n_r, m), lost + dropped)


# --------------------------------------------------------------------------
# frame advance
# --------------------------------------------------------------------------

def _advance_local(pos, vel, alive, u, v, w, static, dt, cfg: SimConfig,
                   spec: SlabSpec, group):
    """One frame of CFL substeps on this rank's slabs. The loop runs on the
    host and reads only reduced values (the CFL velocity, the solves'
    residuals and tolerances), the same on every rank, so every rank takes
    the same substeps."""
    dev = pos.device
    owned = _owned_rows(u.shape[0], spec, dev)
    t = _F32(0.0)
    dt = _F32(dt)
    d = ShardDiagnostics()
    sums = torch.zeros(len(_SUMMED), dtype=torch.int64, device=dev)
    uncovered = torch.zeros(2, dtype=torch.int64, device=dev)
    while t < dt and d.substeps < cfg.max_substeps:
        mv = group.pmax(torch.stack([
            (g.abs() * owned).max() for g in (u, v, w)]).max())
        mv = _F32(mv.item())
        cfl = _F32(cfg.cfl_number * cfg.dx) / mv if mv > 0 else _F32(np.inf)
        sub = min(cfl, _F32(dt - t))
        pos, vel, alive, u, v, w, counts, solves = _substep(
            pos, vel, alive, u, v, w, static, float(sub), cfg, spec, group)
        step_sums = group.psum(torch.stack([counts[k] for k in _SUMMED]))
        sums += step_sums
        uncovered += torch.stack([counts["uncovered_pass_a"],
                                  counts["uncovered_pass_b"]])
        d.substeps += 1
        d.pressure_iterations += solves["pressure_iterations"]
        d.viscosity_iterations += solves["viscosity_iterations"]
        d.viscosity_solves += solves["viscosity_solves"]
        d.viscosity_unconverged += solves["viscosity_unconverged"]
        for k in ("pressure_residual", "pressure_tolerance",
                  "viscosity_residual", "viscosity_tolerance"):
            setattr(d, k, solves[k])
        d.max_velocity = max(d.max_velocity, float(mv))
        d.liquid_cells = step_sums[_SUMMED.index("liquid_cells")]
        t = _F32(t + sub)
    for k in ("pressure_residual", "pressure_tolerance",
              "viscosity_residual", "viscosity_tolerance"):
        setattr(d, k, float(getattr(d, k)))
    d.liquid_cells = int(d.liquid_cells)
    totals = dict(zip(_SUMMED, sums.tolist()))
    del totals["liquid_cells"]
    for k, val in totals.items():
        setattr(d, k, val)
    return pos, vel, alive, u, v, w, d, tuple(uncovered.tolist())


def advance_sharded(ss: ShardedSim, dt, cfg: SimConfig, spec: SlabSpec,
                    group):
    """One frame of CFL substeps over the slab decomposition, each rank of
    `group` on its slab -> (ShardedSim, ShardDiagnostics). Runs where the
    slabs live (the card unless the caller cut them from a CPU state); the
    diagnostics are reduced over the ranks, and the call raises if two
    ranks of this process disagree on them."""
    if group.size != spec.n:
        raise ValueError(f"a group of {group.size} ranks for {spec.n} slabs")
    if tuple(r.rank for r in group.ranks) != tuple(ss.ranks):
        raise ValueError(f"the group drives ranks "
                         f"{[r.rank for r in group.ranks]}, the state holds "
                         f"slabs {list(ss.ranks)}")
    if group.device.type != ss.pos.device.type:
        raise ValueError(f"a group on {group.device} for slabs on "
                         f"{ss.pos.device}")

    def local(g):
        i = ss.ranks.index(g.rank)
        static = tuple(getattr(ss, f)[i] for f in _STATIC) + (ss.gravity,)
        return _advance_local(ss.pos[i], ss.vel[i], ss.alive[i], ss.u[i],
                              ss.v[i], ss.w[i], static, dt, cfg, spec, g)

    outs = group.run(local)
    diags = [o[6] for o in outs]
    for other in diags[1:]:
        if other != diags[0]:
            raise RuntimeError(f"ranks disagree on the frame: {diags[0]} "
                               f"against {other}")
    diag = dataclasses.replace(diags[0],
                               slab_uncovered=tuple(o[7] for o in outs))
    stacked = {name: torch.stack([o[k] for o in outs])
               for k, name in enumerate(("pos", "vel", "alive", "u", "v",
                                         "w"))}
    return ss.replace(**stacked), diag
