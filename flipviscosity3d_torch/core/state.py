"""Simulation state: small dataclasses of tensors, plus a numpy bridge.

Field names are those of the JAX package's SimState / SolidBoundary /
StepDiagnostics, so that a state converted with np.asarray on the JAX side
feeds this package unchanged (state_from_numpy) and back (state_to_numpy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SolidBoundary:
    """Everything derived from the static solid SDF, computed once per
    boundary change."""

    phi: torch.Tensor           # node SDF (I+1,J+1,K+1)
    center_phi: torch.Tensor    # cell-center average (I,J,K)
    weight_u: torch.Tensor      # solid-open face fractions, clamped [0,1]
    weight_v: torch.Tensor
    weight_w: torch.Tensor
    solid_u: torch.Tensor       # viscosity face-state solid masks (bool)
    solid_v: torch.Tensor
    solid_w: torch.Tensor


@dataclasses.dataclass
class SimState:
    """Complete dynamic state of the simulation."""

    pos: torch.Tensor           # (N,3) particle positions
    vel: torch.Tensor           # (N,3) particle velocities
    u: torch.Tensor             # MAC velocity (I+1,J,K)
    v: torch.Tensor             # (I,J+1,K)
    w: torch.Tensor             # (I,J,K+1)
    solid: SolidBoundary
    viscosity: torch.Tensor     # node grid (I+1,J+1,K+1)
    gravity: torch.Tensor       # (3,)

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class StepDiagnostics:
    """Per-advance observability, as host numbers (the advance loop reads
    them from the card once per substep anyway)."""

    substeps: int = 0
    pressure_iterations: int = 0
    pressure_residual: float = 0.0
    viscosity_iterations: int = 0
    viscosity_residual: float = 0.0
    max_velocity: float = 0.0
    bucket_overflow: int = 0
    liquid_cells: int = 0
    # The port's addition: the absolute tolerance the last substep's
    # pressure CG was held to (pressure_residual <= it once converged).
    pressure_tolerance: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_SOLID_FIELDS = tuple(f.name for f in dataclasses.fields(SolidBoundary))
_STATE_FIELDS = tuple(
    f.name for f in dataclasses.fields(SimState) if f.name != "solid")


def state_from_numpy(arrays: dict, device) -> SimState:
    """SimState from a dict of numpy arrays keyed by the JAX field names
    (SimState fields plus the SolidBoundary fields, flat)."""
    def t(name):
        a = np.asarray(arrays[name])
        if a.dtype == np.bool_:
            return torch.from_numpy(a.copy()).to(device)
        return torch.from_numpy(a.astype(np.float32)).to(device)

    solid = SolidBoundary(**{k: t(k) for k in _SOLID_FIELDS})
    return SimState(solid=solid, **{k: t(k) for k in _STATE_FIELDS})


def state_to_numpy(state: SimState) -> dict:
    """The inverse of state_from_numpy: flat dict of numpy arrays."""
    out = {k: getattr(state, k).cpu().numpy() for k in _STATE_FIELDS}
    out.update(
        {k: getattr(state.solid, k).cpu().numpy() for k in _SOLID_FIELDS})
    return out
