"""The pressure and viscosity PCG solves alone, on a state from the middle
of a run, under several preconditioner settings.

    python -m flipviscosity3d_torch.scripts.solver_microbench
        [--device cpu] [--res 64] [--warm-frames 2] [--viscosity 5.0]
        [--bucket-capacity N] [--variant k=v,k=v]

Counterpart of the JAX package's scripts/solver_microbench.py (its RES,
WARM_FRAMES, VISCOSITY, BUCKET_CAPACITY and VARIANT are the flags):
build_state runs warm_frames frames of the bench pool; build_systems
assembles both linear systems from that state as the substep does (pass A
buckets, then the liquid SDF and P2G, the face combine, extrapolation,
gravity, then the viscosity and the pressure system), calling the same
functions as core/step.py; then each solve is timed under the four
variants (Jacobi; multigrid with the automatic level count, with 4 and
with 3 levels), or under the one --variant names (mg_* values are
numbers), with its iterations and ms per iteration. The multigrid solves
run K3 mg_down / K4 mg_up on the card.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import torch

from ..core.step import _P2G_EPS
from ..ops import particle_grid as pg
from ..ops.buckets import build_buckets
from ..ops.extrapolate import extrapolate_velocity_field
from ..ops.grids import (
    face_borders_fluid_u,
    face_borders_fluid_v,
    face_borders_fluid_w,
)
from ..solvers import pressure as psolver
from ..solvers import viscosity as vsolver
from . import main, resolve_device, stage
from .profile_substep import pool_sim

DT = 0.01
VARIANTS = (
    ("jacobi", dict(viscosity_preconditioner="jacobi",
                    pressure_preconditioner="jacobi")),
    ("mg batched L-auto", dict()),
    ("mg batched L4", dict(mg_max_levels=4)),
    ("mg batched L3", dict(mg_max_levels=3)),
)


def build_state(dev, res: int = 64, warm_frames: int = 2,
                viscosity: float = 5.0, bucket_capacity=None):
    """The bench pool after warm_frames frames of DT -> FluidSimulation
    (solver_microbench.py:48-59)."""
    if bucket_capacity is None:
        bucket_capacity = 16 if res >= 128 else 24
    sim = pool_sim(dev, res, viscosity, bucket_capacity=bucket_capacity)
    for _ in range(warm_frames):
        sim.advance(DT)
    return sim


def build_systems(state, cfg, dt: float = DT):
    """Both linear systems of a substep from `state` -> (viscosity system,
    pressure system, (u, v, w) after gravity): solver_microbench.py:62-116
    on the port's modules."""
    solid = state.solid
    dx, shape = cfg.dx, cfg.grid_shape
    table_a = build_buckets(
        state.pos, tuple(state.pos.unbind(1)) + tuple(state.vel.unbind(1)),
        dx, shape, cfg.bucket_capacity)
    liquid_phi, p2g_sums = pg.p2g_and_sdf(
        table_a, shape, dx, cfg.particle_radius, solid.center_phi,
        (cfg.u_shape, cfg.v_shape, cfg.w_shape))
    fluid = liquid_phi < 0
    borders = (face_borders_fluid_u(fluid), face_borders_fluid_v(fluid),
               face_borders_fluid_w(fluid))
    vel, valid = [], []
    for (vsum, wsum), border in zip(p2g_sums, borders):
        mask = (wsum >= _P2G_EPS) & border
        vals = vsum / torch.clamp(wsum, min=_P2G_EPS)
        vel.append(torch.where(mask, vals, torch.zeros_like(vals)))
        valid.append(mask)
    u, v, w, *_ = extrapolate_velocity_field(*vel, *valid,
                                             cfg.extrapolation_layers)
    u, v, w = (torch.where(border, g + state.gravity[a] * dt, g)
               for a, (g, border) in enumerate(zip((u, v, w), borders)))
    states = vsolver.FaceStates(solid.solid_u, solid.solid_v, solid.solid_w)
    volumes = vsolver.compute_volume_grids(liquid_phi, cfg)
    vsys = vsolver.build_viscosity_system(u, v, w, volumes, states,
                                          state.viscosity, dt, cfg)
    psys = psolver.build_pressure_system(
        u, v, w, liquid_phi, solid.weight_u, solid.weight_v, solid.weight_w,
        dt, cfg)
    return vsys, psys, (u, v, w)


def variants(variant=None):
    """VARIANTS, or the one --variant "k=v,k=v" names
    (solver_microbench.py:131-137)."""
    if not variant:
        return VARIANTS
    kv = dict(p.split("=") for p in variant.split(","))
    return ((variant, {
        k: (float(v) if "." in v else int(v)) if k.startswith("mg_") else v
        for k, v in kv.items()}),)


def run(device="cuda", res: int = 64, warm_frames: int = 2,
        viscosity: float = 5.0, bucket_capacity=None, variant=None,
        log=print) -> dict:
    dev = resolve_device(device)
    sim = build_state(dev, res, warm_frames, viscosity, bucket_capacity)
    vsys, psys, uvw = build_systems(sim.state, sim.cfg)
    rows_p = int(psys.fluid.sum())
    rows_v = sum(int(m.sum()) for m in vsys.in_mat)
    log(f"# {res}^3 systems ready; rows p={rows_p} v={rows_v}")
    rows = []
    for name, ov in variants(variant):
        cfg = dataclasses.replace(sim.cfg, **ov)
        rp, res_p = stage(f"p {name}",
                          lambda: psolver.solve_pressure(psys, cfg), dev, log)
        rv, res_v = stage(
            f"v {name}",
            lambda: vsolver.solve_viscosity(vsys, cfg, warm_start=uvw), dev,
            log)
        for r, result in ((rp, res_p), (rv, res_v)):
            r.update(variant=name, iterations=result.iterations,
                     ms_per_iteration=r["wall_ms"] / max(result.iterations, 1),
                     converged=bool(result.converged),
                     residual=float(result.residual))
            rows.append(r)
        log(f"{name:22s} pressure {rp['wall_ms']:8.1f} ms / "
            f"{rp['iterations']:4d} it ({rp['ms_per_iteration']:6.2f} ms/it)"
            f"   viscosity {rv['wall_ms']:8.1f} ms / {rv['iterations']:4d} "
            f"it ({rv['ms_per_iteration']:6.2f} ms/it)")
    return {"check": "solver_microbench", "res": res,
            "warm_frames": warm_frames, "rows_pressure": rows_p,
            "rows_viscosity": rows_v, "rows": rows,
            "ok": all(math.isfinite(r["residual"]) for r in rows)}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=64, warm_frames=2, viscosity=5.0,
                  bucket_capacity=(int, None), variant=(str, None)))
