"""Solid pushback and the SDF solid extrapolation (the part of the JAX
package's ops/stream_transfers.py that the port's engine uses).

Reference: fluidsimulation.cpp:326-333 and interpolation.cpp:122-184 for the
pushback, particlelevelset.cpp:127-139 for the extrapolation.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .grids import shifted_read
from .stream import decode_cells, rows_at_cells

NODE_CORNERS = tuple(itertools.product((0, 1), repeat=3))


def extrapolate_sdf_into_solid(phi, solid_center_phi, dx):
    """phi = -dx/2 in near-surface solid cells."""
    return torch.where((phi < 0.5 * dx) & (solid_center_phi < 0),
                       torch.full_like(phi, float(np.float32(-0.5 * dx))),
                       phi)


def node_corner_columns(phi_node, grid_shape):
    """The 8 per-cell node columns the pushback interpolates, in
    NODE_CORNERS order: column o holds phi_node[cell + o]."""
    return [shifted_read(phi_node, o, grid_shape).reshape(-1)
            for o in NODE_CORNERS]


def solid_pushback_at(px, py, pz, keys, phi_node, dx, grid_shape):
    """Per-particle displacement out of solids: if phi < 0,
    p -= phi * normalize(grad phi). Positions lie inside the domain (keys ==
    floor(p/dx), i-major), so the 8 trilinear corners are the home cell's
    nodes, fetched as one 8-column row gather of the node grid."""
    vals = rows_at_cells(node_corner_columns(phi_node, grid_shape), keys)
    hi, hj, hk = decode_cells(keys, grid_shape)
    tx = px / dx - hi.to(torch.float32)
    ty = py / dx - hj.to(torch.float32)
    tz = pz / dx - hk.to(torch.float32)
    return pushback_from_corners(vals, tx, ty, tz)


def pushback_from_corners(vals, tx, ty, tz):
    """Trilinear phi, its gradient and the projection
    (interpolation.cpp:122-184). vals: 8 tensors in NODE_CORNERS order;
    t*: in-cell fractions."""
    c = dict(zip(NODE_CORNERS, vals))

    def lerp(a, b, t):
        return (1.0 - t) * a + t * b

    def bilerp(v00, v10, v01, v11, s, t):
        return lerp(lerp(v00, v10, s), lerp(v01, v11, s), t)

    phi = lerp(
        bilerp(c[0, 0, 0], c[0, 1, 0], c[0, 0, 1], c[0, 1, 1], ty, tz),
        bilerp(c[1, 0, 0], c[1, 1, 0], c[1, 0, 1], c[1, 1, 1], ty, tz),
        tx,
    )
    gx = bilerp(
        c[1, 0, 0] - c[0, 0, 0], c[1, 1, 0] - c[0, 1, 0],
        c[1, 0, 1] - c[0, 0, 1], c[1, 1, 1] - c[0, 1, 1], ty, tz,
    )
    gy = bilerp(
        c[0, 1, 0] - c[0, 0, 0], c[1, 1, 0] - c[1, 0, 0],
        c[0, 1, 1] - c[0, 0, 1], c[1, 1, 1] - c[1, 0, 1], tx, tz,
    )
    gz = bilerp(
        c[0, 0, 1] - c[0, 0, 0], c[1, 0, 1] - c[1, 0, 0],
        c[0, 1, 1] - c[0, 1, 0], c[1, 1, 1] - c[1, 1, 0], tx, ty,
    )
    len2 = gx * gx + gy * gy + gz * gz
    inv = torch.where(len2 > 0, 1.0 / torch.sqrt(torch.clamp(len2, min=1e-30)),
                      torch.ones_like(len2))
    scale = torch.where(phi < 0, -phi * inv, torch.zeros_like(phi))
    return scale * gx, scale * gy, scale * gz
