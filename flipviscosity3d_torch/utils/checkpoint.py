"""Checkpoint / resume on .npz, shared with the JAX package.

Counterpart of flipviscosity3d_tpu/utils/checkpoint.py. The whole simulation
is one SimState, so exact resume is a flat save and restore of its tensors.
The key names are the JAX package's (its `_flatten`): dotted field paths,
the boundary's fields under `solid.`. A checkpoint written by either package
loads in the other.
"""

from __future__ import annotations

import numpy as np

from ..core.state import SimState, state_from_numpy, state_to_numpy, \
    _SOLID_FIELDS

_SEP = "."
_SOLID = "solid" + _SEP


def _flatten(state: SimState) -> dict[str, np.ndarray]:
    return {(_SOLID + k if k in _SOLID_FIELDS else k): a
            for k, a in state_to_numpy(state).items()}


def save_state(path: str, state: SimState) -> None:
    """Write an exact-resume checkpoint (npz of all state tensors)."""
    np.savez_compressed(path, **_flatten(state))


def load_state(path: str, device="cuda") -> SimState:
    """Restore a SimState saved by save_state (of either package) onto
    `device`."""
    with np.load(path) as data:
        flat = {k.removeprefix(_SOLID): data[k] for k in data.files}
    return state_from_numpy(flat, device)
