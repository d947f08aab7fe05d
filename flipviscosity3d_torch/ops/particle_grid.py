"""Liquid SDF from the per-cell particle slot table (the part of the JAX
package's ops/particle_grid.py that the port's engine uses).

Reference: particlelevelset.cpp:77-139.
"""

from __future__ import annotations

import itertools

import torch

from .buckets import cell_coords
from .grids import shifted_read
from .stream_transfers import extrapolate_sdf_into_solid


def liquid_sdf_from_particles(fields, grid_shape, dx, radius,
                              solid_center_phi):
    """Cell-centered liquid SDF: phi(c) = min(3dx, min over particles in the
    3x3x3 cell window of |center(c) - p| - radius), then -dx/2 in solid
    cells near the surface.

    fields: (px, py, pz), each (cap, n_cells) with far-away positions in
    empty slots. The JAX form builds a (cap, n_cells, 27) broadcast that XLA
    fuses away; here the 27 offsets run as a loop with a running min, so no
    intermediate is larger than (cap, n_cells)."""
    px, py, pz = fields
    coords = cell_coords(grid_shape, px.device).to(torch.float32)
    ux = (coords[0] + 0.5) * dx - px
    uy = (coords[1] + 0.5) * dx - py
    uz = (coords[2] + 0.5) * dx - pz
    phi = torch.full(grid_shape, 3.0 * dx, dtype=torch.float32,
                     device=px.device)
    for o in itertools.product((-1, 0, 1), repeat=3):
        tx = ux + o[0] * dx
        ty = uy + o[1] * dx
        tz = uz + o[2] * dx
        d2 = tx * tx + ty * ty + tz * tz
        m = torch.sqrt(d2.min(dim=0).values) - radius
        # the source cell's min for offset o lands at target cell c + o
        phi = torch.minimum(
            phi, shifted_read(m.reshape(grid_shape), tuple(-v for v in o),
                              grid_shape, fill=float("inf")))
    return extrapolate_sdf_into_solid(phi, solid_center_phi, dx)
