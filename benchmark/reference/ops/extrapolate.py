"""Fixed-layer masked velocity extrapolation.

`num_layers` Jacobi sweeps with the semantics of the reference's BFS
layering (macvelocityfield.cpp:580-694):

- a cell is newly filled in a layer iff it is not on the array border and has
  at least one KNOWN 6-neighbor that is itself *interior* (the reference's
  discovery loop only scans interior source cells, so a candidate adjacent
  only to border KNOWN cells is never discovered);
- the filled value is the average of ALL currently-KNOWN 6-neighbors
  (border KNOWN cells do contribute to the average);
- cells filled in a layer become KNOWN only for subsequent layers.
"""

from __future__ import annotations

import torch

from .grids import interior_mask, shifted_read

_NEIGHBOR_OFFSETS = (
    (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)
)


def extrapolate_grid(grid, valid, num_layers: int, interior=None,
                     exchange=None):
    """Extrapolate `grid` values from `valid` cells outward `num_layers`
    times. Returns (grid, valid) after extrapolation.

    `interior` replaces the not-on-array-border mask (the slab pipeline
    passes its rows' interiority in the GLOBAL domain); `exchange(g, v) ->
    (g, v)` runs before each layer (the slabs' halo refresh)."""
    shape = grid.shape
    if interior is None:
        interior = interior_mask(shape, grid.device)
    g, v = grid, valid
    for _ in range(num_layers):
        if exchange is not None:
            g, v = exchange(g, v)
        vf = v.to(g.dtype)
        v_int = (v & interior).to(g.dtype)
        cnt_all = torch.zeros_like(g)
        cnt_int = torch.zeros_like(g)
        s = torch.zeros_like(g)
        gv = g * vf
        for o in _NEIGHBOR_OFFSETS:
            cnt_all = cnt_all + shifted_read(vf, o, shape)
            cnt_int = cnt_int + shifted_read(v_int, o, shape)
            s = s + shifted_read(gv, o, shape)
        newval = s / torch.clamp(cnt_all, min=1.0)
        update = (~v) & (cnt_int > 0) & interior
        g = torch.where(update, newval, g)
        v = v | update
    return g, v


def extrapolate_velocity_field(u, v, w, valid_u, valid_v, valid_w,
                               num_layers: int):
    """extrapolateVelocityField over the three MAC components
    (macvelocityfield.cpp:689-694)."""
    u, valid_u = extrapolate_grid(u, valid_u, num_layers)
    v, valid_v = extrapolate_grid(v, valid_v, num_layers)
    w, valid_w = extrapolate_grid(w, valid_w, num_layers)
    return u, v, w, valid_u, valid_v, valid_w
