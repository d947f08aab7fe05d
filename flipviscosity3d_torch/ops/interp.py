"""Trilinear sampling of node grids with the reference's conventions
(interpolation.cpp:68-108): base = floor(pos/dx), out-of-range corners
contribute 0. The part of the JAX package's ops/interp.py that seeding
uses."""

from __future__ import annotations

import torch


def gather_grid(grid, idx):
    """grid[idx] with out-of-range indices yielding 0; idx: (..., 3) int."""
    shp = torch.tensor(grid.shape, dtype=idx.dtype, device=idx.device)
    ok = ((idx >= 0) & (idx < shp)).all(dim=-1)
    c = torch.minimum(torch.clamp(idx, min=0), shp - 1)
    vals = grid[c[..., 0], c[..., 1], c[..., 2]]
    return torch.where(ok, vals, torch.zeros_like(vals))


def trilinear(grid, pos, dx):
    """Trilinear sample of a node-indexed grid at (..., 3) world positions."""
    f = pos / dx
    base = torch.floor(f)
    t = f - base
    base = base.to(torch.int64)
    total = 0.0
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = ((t[..., 0] if di else 1.0 - t[..., 0])
                     * (t[..., 1] if dj else 1.0 - t[..., 1])
                     * (t[..., 2] if dk else 1.0 - t[..., 2]))
                off = torch.tensor([di, dj, dk], device=pos.device)
                total = total + w * gather_grid(grid, base + off)
    return total
