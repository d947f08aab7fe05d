"""Jacobi against multigrid preconditioning on the viscous pool.

    python -m flipviscosity3d_torch.scripts.precond_experiment
        [--device cpu] [--res 64] [--frames 3] [--viscosity 5.0]
        [--modes jacobi,multigrid] [--mg-pre N] [--mg-post N]
        [--mg-coarse-size N] [--mg-max-levels N] [--mg-omega X]
        [--mg-coarse-scale X]

Counterpart of the JAX package's scripts/precond_experiment.py (its RES,
FRAMES, VISCOSITY, MODES and MG_* knobs are the flags): per mode
("jacobi": both solves Jacobi; "multigrid": both multigrid, with the
--mg-* overrides; "mixed": Jacobi pressure, multigrid viscosity) the pool
scene runs one warm frame and `frames` timed frames of dt 0.01, and the
line gives the substeps, the pressure and viscosity iterations per
substep, the wall seconds and substeps/s. The multigrid modes run K3
mg_down / K4 mg_up on the card.
"""

from __future__ import annotations

import sys
import time

import torch

from ..core import step as step_mod
from . import main, resolve_device
from .profile_substep import pool_sim

DT = 0.01
# the --mg-* flags and the SimConfig fields they set
MG_FIELDS = (("mg_pre", "mg_pre_smooth"), ("mg_post", "mg_post_smooth"),
             ("mg_coarse_size", "mg_coarse_size"),
             ("mg_max_levels", "mg_max_levels"), ("mg_omega", "mg_omega"),
             ("mg_coarse_scale", "mg_coarse_scale"))


def mode_overrides(mode: str, mg: dict) -> tuple:
    """(label, SimConfig overrides) of one mode (precond_experiment.py:
    100-115); `mg` holds the set --mg-* fields."""
    if mode == "jacobi":
        return "jacobi/jacobi", dict(viscosity_preconditioner="jacobi",
                                     pressure_preconditioner="jacobi")
    if mode == "multigrid":
        tag = ",".join(f"{k.split('_')[-1]}={v}" for k, v in mg.items())
        return f"mg/mg {tag}", dict(viscosity_preconditioner="multigrid",
                                    pressure_preconditioner="multigrid", **mg)
    if mode == "mixed":
        return "jacobi-p/mg-v", dict(viscosity_preconditioner="multigrid",
                                     pressure_preconditioner="jacobi", **mg)
    raise ValueError(f"unknown mode {mode!r}")


def frames_from(state, cfg, frames: int) -> tuple:
    """`frames` frames of DT from `state` -> (state, substeps, pressure
    iterations, viscosity iterations), summed over the frames."""
    sub = p_it = v_it = 0
    for _ in range(frames):
        state, d = step_mod.advance(state, DT, cfg)
        sub += d.substeps
        p_it += d.pressure_iterations
        v_it += d.viscosity_iterations
    return state, sub, p_it, v_it


def run(device="cuda", res: int = 64, frames: int = 3,
        viscosity: float = 5.0, modes: str = "jacobi,multigrid",
        mg_pre=None, mg_post=None, mg_coarse_size=None, mg_max_levels=None,
        mg_omega=None, mg_coarse_scale=None, log=print) -> dict:
    dev = resolve_device(device)
    flags = dict(mg_pre=mg_pre, mg_post=mg_post,
                 mg_coarse_size=mg_coarse_size, mg_max_levels=mg_max_levels,
                 mg_omega=mg_omega, mg_coarse_scale=mg_coarse_scale)
    mg = {field: flags[flag] for flag, field in MG_FIELDS
          if flags[flag] is not None}
    log(f"# scene: {res}^3 pool, viscosity {viscosity}, {frames} frames")
    lines = []
    for mode in modes.split(","):
        name, ov = mode_overrides(mode, mg)
        sim = pool_sim(dev, res, viscosity, **ov)
        sim.advance(DT)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, sub, p_it, v_it = frames_from(sim.state, sim.cfg, frames)
        wall = time.perf_counter() - t0
        line = {"mode": name, "substeps": sub,
                "p_iters_per_sub": p_it / max(sub, 1),
                "v_iters_per_sub": v_it / max(sub, 1), "wall_s": wall,
                "steps_per_s": sub / wall,
                "finite": bool(torch.isfinite(state.pos).all())}
        log(f"{name:30s} substeps={sub:3d} "
            f"p_iters/sub={line['p_iters_per_sub']:7.1f} "
            f"v_iters/sub={line['v_iters_per_sub']:7.1f} "
            f"wall={wall:7.2f}s  ({line['steps_per_s']:6.2f} steps/s)")
        lines.append(line)
    return {"check": "precond_experiment", "res": res, "frames": frames,
            "modes": lines, "ok": all(m["finite"] for m in lines)}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=64, frames=3, viscosity=5.0,
                  modes="jacobi,multigrid", mg_pre=(int, None),
                  mg_post=(int, None), mg_coarse_size=(int, None),
                  mg_max_levels=(int, None), mg_omega=(float, None),
                  mg_coarse_scale=(float, None)))
