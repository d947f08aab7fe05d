"""Home-cell indexing shared by the particle transfers (the part of the JAX
package's ops/buckets.py that the port's engine uses)."""

from __future__ import annotations

import torch


def cell_of_position(pos, dx, grid_shape):
    """Clamped home cell of (N,3) positions -> i-major flat index
    (grid3d.h:37-43 floor semantics, clamped into the grid)."""
    idx = torch.floor(pos / dx).to(torch.int64)
    i, j, k = (idx[:, a].clamp(0, grid_shape[a] - 1) for a in range(3))
    return (i * grid_shape[1] + j) * grid_shape[2] + k


def cell_coords(grid_shape, device=None):
    """(3, n_cells) int64 coordinates of every i-major flat cell index."""
    ii, jj, kk = torch.meshgrid(
        *(torch.arange(n, device=device) for n in grid_shape), indexing="ij")
    return torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)])
