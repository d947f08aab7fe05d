"""One substep at 256^3 (BASELINE config 4's scale) on a single device.

    python -m flipviscosity3d_torch.scripts.readiness256 [--device cpu]
        [--res 256] [--npart 500000] [--engine pallas]

Counterpart of the JAX package's scripts/readiness256.py (its RES, NPART
and ENGINE are the flags): a simulation at res^3 on `engine` with
bucket_capacity 8 and viscosity 5, whose solid is the analytic inverted
box (analytic_boundary_sdf, so that setup runs no mesh-to-SDF pass), and
npart particles uniform in [2/res, 1 - 2/res] x [2/res, 0.25] x [2/res,
1 - 2/res], made on the device from a torch.Generator seeded 1. It runs
core/step.step once with dt 0.004 (the first call, kernel build and card
warm-up included) and once more warm, and prints both times, the mean
height com_y, the overflow and both iteration counts, then READY. At
256^3 (>= 2^24 cells) under "pallas" the substep launches the K-folded K1,
K2 of two grids and of one, and K3 / K4 in the V-cycles.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import SimConfig
from ..core import step as step_mod
from ..core.sim import FluidSimulation
from ..ops.mesh_sdf import MeshLevelSet
from . import main, resolve_device

DT = 0.004


def analytic_boundary_sdf(cfg, dev) -> MeshLevelSet:
    """The node SDF of the domain box inset by 1.5 dx + 5e-7, negated: the
    closed form of FluidSimulation._domain_boundary_sdf's mesh version
    (the JAX scripts readiness256.py:36-56 and readiness512.py:57-71),
    computed in float64 axis by axis and stored as float32."""
    inset = 0.5 * (3.0 * cfg.dx + 1e-6)
    q = []
    for a, s in enumerate((cfg.isize, cfg.jsize, cfg.ksize)):
        p = torch.arange(s + 1, dtype=torch.float64, device=dev) * cfg.dx
        qa = torch.maximum(inset - p, p - (s * cfg.dx - inset))
        shape = [1, 1, 1]
        shape[a] = s + 1
        q.append(qa.reshape(shape))
    outside = torch.sqrt(sum(torch.clamp(qa, min=0.0) ** 2 for qa in q))
    inside = torch.clamp(torch.maximum(torch.maximum(q[0], q[1]), q[2]),
                         max=0.0)
    return MeshLevelSet((-(outside + inside)).to(torch.float32), cfg.dx)


def readiness_sim(dev, cfg, viscosity: float, pos) -> FluidSimulation:
    """A FluidSimulation of `cfg` with the analytic solid, a uniform
    viscosity and the particles `pos`, its fields set as the JAX scripts
    set them (readiness256.py:70-88)."""
    sim = FluidSimulation(dev)
    sim.cfg = cfg
    sim._viscosity = torch.full(cfg.node_shape, float(viscosity),
                                device=dev)
    sim._solid_sdf = analytic_boundary_sdf(cfg, dev)
    sim._particles_pos = [pos]
    sim._state = None
    return sim


def build_state(dev, res: int = 256, npart: int = 500_000,
                engine: str = "pallas"):
    """(SimState, SimConfig) of the readiness scene."""
    cfg = SimConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res,
                    particle_engine=engine, bucket_capacity=8)
    m = 2.0 / res
    lo = torch.tensor([m, m, m], device=dev)
    hi = torch.tensor([1.0 - m, 0.25, 1.0 - m], device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    pos = torch.rand((npart, 3), generator=gen, device=dev) * (hi - lo) + lo
    return readiness_sim(dev, cfg, 5.0, pos).state, cfg


def run(device="cuda", res: int = 256, npart: int = 500_000,
        engine: str = "pallas", log=print) -> dict:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state, cfg = build_state(dev, res, npart, engine)
    log(f"state built: {res}^3, {npart} particles (engine="
        f"{cfg.particle_engine}, cap={cfg.bucket_capacity})")
    dt = float(np.float32(DT))
    t0 = time.perf_counter()
    new, diag = step_mod.step(state, dt, cfg)
    com = float(new.pos[:, 1].mean())
    first = time.perf_counter() - t0
    finite = bool(torch.isfinite(new.pos).all())
    out = dict(overflow=int(diag["bucket_overflow"]),
               pressure_iterations=int(diag["pressure_iterations"]),
               viscosity_iterations=int(diag["viscosity_iterations"]))
    log(f"substep built+ran in {first:.1f}s  com_y={com:.5f} "
        f"overflow={out['overflow']} iters: "
        f"pressure={out['pressure_iterations']} "
        f"viscosity={out['viscosity_iterations']}")
    del new, diag
    t0 = time.perf_counter()
    new, _ = step_mod.step(state, dt, cfg)
    float(new.pos[:, 1].mean())
    warm = time.perf_counter() - t0
    log(f"warm substep {warm:.2f}s")
    ok = finite and bool(np.isfinite(com))
    if ok:
        log("READY")
    return {"check": "readiness256", "res": res, "particles": npart,
            "engine": cfg.particle_engine, "cap": cfg.bucket_capacity,
            "first_substep_s": first, "warm_substep_s": warm, "com_y": com,
            **out, "finite": finite,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None), "ok": ok}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=256, npart=500_000, engine="pallas"))
