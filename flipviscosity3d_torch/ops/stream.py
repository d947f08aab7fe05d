"""Row gathers keyed by per-particle cell indices (the part of the JAX
package's ops/stream.py that the port's engine uses)."""

from __future__ import annotations

import torch


def rows_at_cells(columns, keys):
    """Per-particle rows of stacked per-cell columns: ONE (N, C) row gather.
    columns: (n_cells,) tensors; keys: (N,) i-major cell indices. Returns a
    list of (N,) tensors, one per column."""
    rows = torch.stack(columns, dim=-1)[keys]
    return list(rows.unbind(dim=1))


def decode_cells(keys, grid_shape):
    """i-major flat cell index -> (i, j, k) coordinates."""
    jk = grid_shape[1] * grid_shape[2]
    i = keys // jk
    rem = keys - i * jk
    j = rem // grid_shape[2]
    k = rem - j * grid_shape[2]
    return i, j, k
