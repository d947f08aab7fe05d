"""Per-stage timing of the substep pipeline.

    python -m flipviscosity3d_torch.scripts.profile_substep [--device cpu]
        [--res 128]

Counterpart of the JAX package's scripts/profile_substep.py (its
PROFILE_RESOLUTION is --res). The scene is the bench pool at res^3 (a box
from 2.5 / res to y = 0.285, viscosity 5) under the default SimConfig, the
"table" engine as in the JAX script; each row calls the port's counterpart
of the JAX row's function on its state:

- dispatch floor: one tiny op;
- ops/buckets.build_buckets, pass A's sort and table scatter;
- ops/particle_grid: the liquid SDF (27 offsets), P2G of one component,
  G2P of 3 components x 2 grids; ops/buckets.gather_results x6;
- ops/extrapolate: 3 components, 7 layers;
- solvers/pressure: the system build, 30 matvecs, each step normalised by
  max|x|; solvers/viscosity: the volume grids, the build, 30 matvecs;
- core/step.advance of one frame (dt 0.01): the FULL row, whose V-cycles
  run K3 mg_down and K4 mg_up on the card.

A row gives wall_ms and device_ms (flipviscosity3d_torch.scripts.stage)
and its share of the FULL advance's wall time.
"""

from __future__ import annotations

import sys

import torch

from ..core import step as step_mod
from ..core.sim import FluidSimulation
from ..io.trianglemesh import box_mesh
from ..ops import particle_grid as pg
from ..ops.buckets import build_buckets, gather_results
from ..ops.extrapolate import extrapolate_velocity_field
from ..solvers import pressure as psolver
from ..solvers import viscosity as vsolver
from . import main, resolve_device, stage

# the JAX script's rows, in its order
ROWS = ("dispatch floor (tiny op)", "build_buckets (sort+scatter)",
        "liquid SDF (27 offsets)", "p2g one component (18 offsets)",
        "g2p 3 components x2 grids", "gather_results x6",
        "extrapolate 3 comps x7 layers", "pressure build",
        "pressure matvec x30", "viscosity volume grids (7)",
        "viscosity build", "viscosity matvec x30", "FULL advance (1 frame)")
FULL = ROWS[-1]
DT = 0.01


def pool_sim(dev, res: int, viscosity: float = 5.0,
             **cfg_overrides) -> FluidSimulation:
    """The JAX scripts' pool (profile_substep.py:45-50, and
    solver_microbench's and precond_experiment's): a box from 2.5 / res to
    y = 0.285, under a res^3 SimConfig with `cfg_overrides`."""
    sim = FluidSimulation(dev)
    sim.initialize(res, res, res, 1.0 / res, **cfg_overrides)
    lo = 2.5 / res
    sim.add_liquid(box_mesh((lo, lo, lo), (1 - lo, 0.285, 1 - lo)))
    sim.set_viscosity(viscosity)
    return sim


def _normalised(y):
    return y / torch.clamp(y.abs().max(), min=1e-30)


def run(device="cuda", res: int = 128, log=print) -> dict:
    dev = resolve_device(device)
    sim = pool_sim(dev, res)
    state, cfg = sim.state, sim.cfg
    solid = state.solid
    shape, dx = cfg.grid_shape, cfg.dx
    n = int(state.pos.shape[0])
    log(f"# {res}^3, {n} particles, cap {cfg.bucket_capacity}")
    rows = []

    def row(name, fn):
        r, out = stage(name, fn, dev, log)
        rows.append(r)
        return out

    ones = torch.ones(8, device=dev)
    row(ROWS[0], lambda: ones + 1)
    tbl = row(ROWS[1], lambda: build_buckets(
        state.pos, tuple(state.pos.unbind(1)) + tuple(state.vel.unbind(1)),
        dx, shape, cfg.bucket_capacity))
    phi = row(ROWS[2], lambda: pg.liquid_sdf_from_particles(
        tbl, shape, dx, cfg.particle_radius, solid.center_phi))
    u = row(ROWS[3], lambda: pg.p2g_component(
        tbl, tbl.fields[3], shape, dx, "u", cfg.u_shape))[0]
    row(ROWS[4], lambda: (
        pg.sample_mac_at_table(tbl, u, state.v, state.w, dx),
        pg.sample_mac_at_table(tbl, u, state.v, state.w, dx)))
    row(ROWS[5], lambda: gather_results(tbl, tbl.fields[:6]))
    valid = torch.zeros(cfg.u_shape, dtype=torch.bool, device=dev)
    valid[1:-1, 1:-1, 1:-1] = True
    none_v = torch.zeros(cfg.v_shape, dtype=torch.bool, device=dev)
    none_w = torch.zeros(cfg.w_shape, dtype=torch.bool, device=dev)
    row(ROWS[6], lambda: extrapolate_velocity_field(
        u, state.v, state.w, valid, none_v, none_w, 7))
    psys = row(ROWS[7], lambda: psolver.build_pressure_system(
        u, state.v, state.w, phi, solid.weight_u, solid.weight_v,
        solid.weight_w, DT, cfg))

    def pressure_matvecs():
        x = psys.b
        for _ in range(30):
            x = psolver.apply_pressure_matrix(psys, x) / torch.clamp(
                x.abs().max(), min=1e-30)
        return x

    row(ROWS[8], pressure_matvecs)
    vols = row(ROWS[9], lambda: vsolver.compute_volume_grids(phi, cfg))
    states = vsolver.FaceStates(solid.solid_u, solid.solid_v, solid.solid_w)
    vsys = row(ROWS[10], lambda: vsolver.build_viscosity_system(
        u, state.v, state.w, vols, states, state.viscosity, DT, cfg))

    def viscosity_matvecs():
        x = vsys.rhs
        for _ in range(30):
            x = tuple(_normalised(y)
                      for y in vsolver.apply_viscosity_matrix(vsys, x))
        return x

    row(ROWS[11], viscosity_matvecs)
    new, diag = row(FULL, lambda: step_mod.advance(state, DT, cfg))
    full = rows[-1]["wall_ms"]
    for r in rows:
        r["share_of_full"] = r["wall_ms"] / full
    ok = bool(torch.isfinite(new.pos).all())
    return {"check": "profile_substep", "res": res, "particles": n,
            "engine": cfg.particle_engine, "substeps": diag.substeps,
            "pressure_iterations": diag.pressure_iterations,
            "viscosity_iterations": diag.viscosity_iterations,
            "rows": rows, "ok": ok}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=128))
