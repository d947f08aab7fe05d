"""The output check: what the window's substeps produced, against the plain
reference (reference/), which imports nothing of the program.

The reference cannot replay a whole window on its own: particles are
indistinguishable and a liquid's motion amplifies rounding, so after a
few substeps two correct simulations hold different particles in
different places. So it follows the program step by step, as the
program's own state hands it over, and checks the start and each step on
its own:

- start: the reference builds the scene from the same configuration and
  seed with its own code and holds the snapshot the window replays
  from against it (particle positions, the solid boundary's fields).
- each recorded substep: from the program's positions, velocities and
  grids before it, with the reference's own solid boundary, viscosity and
  gravity, the reference works out the substep's dt again (the CFL rule
  and the time left in the frame) and runs the substep in plain PyTorch
  in float32; the program's output state is held against it.

Numbers compared (each the worst over the records):
  start_gap  positions and solid fields of the snapshot against the
             reference's scene, max |difference| (in cells for positions),
             inf if the particle counts differ
  dt_gap     |program's substep dt - reference's| / reference's
  pos_gap    max |position difference| / dx
  vel_gap    max |velocity difference| / max |reference velocity|
  grid_gap   max over u, v, w of max |difference| / max |reference|
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

NAMES = ("start_gap", "dt_gap", "pos_gap", "vel_gap", "grid_gap")


def _max_abs_diff(a, b) -> float:
    if a.shape != b.shape:
        return math.inf
    d = (a.float() - b.float()).abs()
    return float(d.max()) if d.numel() else 0.0


def _max_abs(a) -> float:
    return float(a.abs().max()) if a.numel() else 0.0


def _rel(a, b) -> float:
    gap = _max_abs_diff(a, b)
    return gap / max(_max_abs(b), 1e-30) if gap else 0.0


def start_gap(snap, ref_state, dx: float) -> float:
    gaps = [_max_abs_diff(snap.pos, ref_state.pos) / dx]
    for f in dataclasses.fields(ref_state.solid):
        got, want = getattr(snap.solid, f.name), getattr(ref_state.solid,
                                                         f.name)
        if want.dtype == torch.bool:
            gaps.append(math.inf if got.shape != want.shape
                        else float((got != want).sum()))
        else:
            gaps.append(_rel(got, want))
    gaps.append(_rel(snap.viscosity, ref_state.viscosity))
    gaps.append(_rel(snap.gravity, ref_state.gravity))
    return max(gaps)


def reference_dt(ref_step, state, cfg, frame_dt: float,
                 t_before: np.float32) -> float:
    """The substep length advance takes from `state` with `t_before` of the
    frame gone (core/step.py::advance's f32 arithmetic)."""
    f32 = np.float32
    maxvel = f32(ref_step._max_velocity(state.u, state.v, state.w).item())
    cfl = (f32(cfg.cfl_number * cfg.dx) / maxvel if maxvel > 0
           else f32(np.inf))
    return float(min(cfl, f32(f32(frame_dt) - t_before)))


def judge(records, snap, spec, seed: int, device, log=print) -> dict:
    """The compared numbers of a run: its snapshot and records against the
    reference. Frees the records as it goes."""
    from . import scene
    from .reference.core import step as ref_step

    out = dict.fromkeys(NAMES, 0.0)
    ref_sim = scene.build(scene.reference(), spec, seed, device)
    ref_static = ref_sim.state
    cfg = ref_sim.cfg
    out["start_gap"] = start_gap(snap, ref_static, cfg.dx)
    del snap
    for frame in sorted(records):
        rec = records.pop(frame)
        got = rec.state_out
        state_in = ref_static.replace(
            **{k: getattr(rec.state_in, k) for k in ("pos", "vel", "u", "v",
                                                     "w")})
        del rec.state_in
        dt = reference_dt(ref_step, state_in, cfg, float(spec["frame_dt"]),
                          rec.t_before)
        out["dt_gap"] = max(out["dt_gap"], abs(rec.dt - dt) / dt)
        want, _ = ref_step.step(state_in, dt, cfg, substep_idx=rec.substep)
        del state_in
        gaps = {
            "pos_gap": _max_abs_diff(got.pos, want.pos) / cfg.dx,
            "vel_gap": _rel(got.vel, want.vel),
            "grid_gap": max(_rel(getattr(got, k), getattr(want, k))
                            for k in ("u", "v", "w")),
        }
        log(f"check frame {frame} substep {rec.substep}: dt {rec.dt!r} "
            f"(reference {dt!r}) " + " ".join(f"{k} {v!r}"
                                               for k, v in gaps.items()))
        for k, v in gaps.items():
            out[k] = max(out[k], v)
        del got, want, rec
    return out
