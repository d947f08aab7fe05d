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
    # The port's additions: the absolute tolerances the last substep's
    # pressure and viscosity CGs were held to (a residual is <= its
    # tolerance once converged; 0 where the solve did not run).
    pressure_tolerance: float = 0.0
    viscosity_tolerance: float = 0.0
    # The port's additions: substeps that ran pass A "stale" without a
    # re-sort (0 under pass A "sort"), and the particle-substeps that the
    # pass-A, midpoint and pushback visit plans left uncovered (each a part
    # of bucket_overflow; 0 where the variant has no plan).
    stale_substeps: int = 0
    uncovered_pass_a: int = 0
    uncovered_pass_b: int = 0
    uncovered_pushback: int = 0
    # The port's addition: the most visits per chunk that a visit plan of
    # the frame asked for (0 without plans); a plan's coverage is cut once
    # this exceeds its capacity (pallas_*_factor at the bench scene).
    plan_demand: float = 0.0
    # The port's additions: the frame's reads from the device by site
    # (utils/trace.read), and while a profiler records, its spans by name:
    # {name: {"calls", "host_ms", "stream_ms"}} (utils/trace.Frame); empty
    # otherwise.
    host_reads: dict = dataclasses.field(default_factory=dict)
    stages: dict = dataclasses.field(default_factory=dict)

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
