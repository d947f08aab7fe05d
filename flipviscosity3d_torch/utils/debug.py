"""Debug and invariant-checking aids.

Counterpart of flipviscosity3d_tpu/utils/debug.py (the reference's
FLUIDSIM_ASSERT, fluidsimassert.h:24-40): NaN trapping and post-step state
validation on the host.
"""

from __future__ import annotations

import torch


def enable_debug(nan_checks: bool = True) -> None:
    """Turn on torch-level debugging. `nan_checks` maps to
    torch.autograd.set_detect_anomaly, the closest PyTorch has to JAX's
    jax_debug_nans: it traps NaNs that a backward pass produces, and the
    simulator runs none, so for a forward-only run validate_state is the
    check that finds them. JAX's `disable_jit` has no counterpart and is
    left out: the port runs eagerly and is debuggable as it is."""
    torch.autograd.set_detect_anomaly(bool(nan_checks))


def validate_state(state, cfg) -> list[str]:
    """Host-side invariant checks on a SimState; returns violation strings
    (empty list = healthy). Mirrors the reference's runtime domain and index
    range assertions (fluidsimulation.cpp:48-49,67-68,
    particlelevelset.cpp:45,55)."""
    problems = []
    ext = torch.tensor([cfg.isize, cfg.jsize, cfg.ksize],
                       dtype=torch.float32, device=state.pos.device) * cfg.dx
    if not bool(torch.isfinite(state.pos).all()):
        problems.append("non-finite particle positions")
    if not bool(torch.isfinite(state.vel).all()):
        problems.append("non-finite particle velocities")
    if bool((state.pos < 0).any()) or bool((state.pos >= ext).any()):
        problems.append("particles outside the domain box")
    for name in ("u", "v", "w"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            problems.append(f"non-finite {name} velocity grid")
    return problems
