"""Particle<->grid transfers over the sorted stream (no tables).

Counterpart of flipviscosity3d_tpu/ops/stream_transfers.py: the semantics
of ops/particle_grid.py with per-particle tensors and segment reductions
(ops/stream.py), the float expressions in the JAX package's order. The
solid pushback and the SDF's solid extrapolation here serve every engine.

Reference:
- liquid SDF from particle spheres over the 3x3x3 window
  (particlelevelset.cpp:98-139), extrapolated into solids (:127-139);
- P2G with the Wyvill kernel, weight-normalized (fluidsimulation.cpp:364-438);
- trilinear MAC sampling with half-dx transverse shifts, out of domain -> 0
  (macvelocityfield.cpp:455-578);
- solid SDF pushback along the interpolated gradient
  (fluidsimulation.cpp:326-333, interpolation.cpp:122-184).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .grids import shifted_read
from .stream import ParticleStream, decode_cells, rows_at_cells, segment_reduce

NODE_CORNERS = tuple(itertools.product((0, 1), repeat=3))
_MAC_OFFSETS = {
    "u": (0.0, 0.5, 0.5),
    "v": (0.5, 0.0, 0.5),
    "w": (0.5, 0.5, 0.0),
}
_COMP_AXIS = {"u": 0, "v": 1, "w": 2}


def _windows(component):
    ax = _COMP_AXIS[component]
    return [(0, 1) if a == ax else (-1, 0, 1) for a in range(3)]


def _wyvill_weight(d2, dx):
    """Wyvill kernel (fluidsimulation.cpp:385-413), zero at and beyond
    r = dx; the constants rounded to f32 as the JAX package rounds them."""
    r2 = float(np.float32(dx * dx))
    c1 = float(np.float32((4.0 / 9.0) / dx**6))
    c2 = float(np.float32((17.0 / 9.0) / dx**4))
    c3 = float(np.float32((22.0 / 9.0) / dx**2))
    w = 1.0 - c1 * d2 * d2 * d2 + c2 * d2 * d2 - c3 * d2
    return torch.where(d2 < r2, w, torch.zeros_like(w))


def extrapolate_sdf_into_solid(phi, solid_center_phi, dx):
    """phi = -dx/2 in near-surface solid cells."""
    return torch.where((phi < 0.5 * dx) & (solid_center_phi < 0),
                       torch.full_like(phi, float(np.float32(-0.5 * dx))),
                       phi)


def p2g_sdf_stream(stream: ParticleStream, grid_shape, dx, radius,
                   solid_center_phi, face_shapes, finalize=True):
    """Pass A of the stream engine: the liquid SDF and all three P2G
    components. Per particle, 27 SDF distances and, per component, 18
    offsets x (weight, weight * velocity); all reduce per cell in ONE
    segment_reduce, then land on the grids by static shifted accumulation,
    as the table engine's do.

    Returns (phi, [(val_sum, w_sum) per component])."""
    px, py, pz = stream.sorted[0], stream.sorted[1], stream.sorted[2]
    vels = (stream.sorted[3], stream.sorted[4], stream.sorted[5])
    hi, hj, hk = decode_cells(stream.key, grid_shape)
    hx = hi.to(torch.float32) * dx
    hy = hj.to(torch.float32) * dx
    hz = hk.to(torch.float32) * dx
    del hi, hj, hk
    max_dist = float(np.float32(3.0 * dx))

    offsets = list(itertools.product((-1, 0, 1), repeat=3))
    mins, sums = [], []
    sum_layout = []   # (component index, offset) per (w, wv) pair
    for o in offsets:
        dxp = hx + (o[0] + 0.5) * dx - px
        dyp = hy + (o[1] + 0.5) * dx - py
        dzp = hz + (o[2] + 0.5) * dx - pz
        mins.append(torch.sqrt(dxp * dxp + dyp * dyp + dzp * dzp) - radius)
        del dxp, dyp, dzp
        for ci, comp in enumerate("uvw"):
            if o[_COMP_AXIS[comp]] not in (0, 1):
                continue
            off = _MAC_OFFSETS[comp]
            fx = hx + o[0] * dx - (px - off[0] * dx)
            fy = hy + o[1] * dx - (py - off[1] * dx)
            fz = hz + o[2] * dx - (pz - off[2] * dx)
            w = _wyvill_weight(fx * fx + fy * fy + fz * fz, dx)
            del fx, fy, fz
            sums.append(w)
            sums.append(w * vels[ci])
            sum_layout.append((ci, o))
    del hx, hy, hz

    sum_cells, min_cells = segment_reduce(stream, sums, mins, max_dist)
    del sums, mins

    phi = torch.full(grid_shape, max_dist, dtype=torch.float32,
                     device=px.device)
    for o, m in zip(offsets, min_cells):
        neg = tuple(-v for v in o)
        phi = torch.minimum(phi, shifted_read(m.reshape(grid_shape), neg,
                                              grid_shape, fill=float("inf")))
    if finalize:
        phi = extrapolate_sdf_into_solid(phi, solid_center_phi, dx)

    acc = {c: (torch.zeros(fs, device=px.device),
               torch.zeros(fs, device=px.device))
           for c, fs in zip("uvw", face_shapes)}
    for idx, (ci, o) in enumerate(sum_layout):
        comp = "uvw"[ci]
        fs = face_shapes[ci]
        neg = tuple(-v for v in o)
        ws = sum_cells[2 * idx].reshape(grid_shape)
        wv = sum_cells[2 * idx + 1].reshape(grid_shape)
        vs_, ss_ = acc[comp]
        acc[comp] = (vs_ + shifted_read(wv, neg, fs),
                     ss_ + shifted_read(ws, neg, fs))
    return phi, [acc[c] for c in "uvw"]


def sample_mac_at(px, py, pz, keys, grids_u, grids_v, grids_w, dx,
                  grid_shape, valid=None):
    """Trilinear MAC samples of several grids at per-particle positions.

    grids_u/v/w: lists of same-component grids that share the trilinear
    weights (the new and the FLIP-saved fields). The per-cell columns of
    every (component, grid, offset) stack into ONE row gather keyed by each
    particle's cell, then combine with per-particle weights. Returns
    (samples_u, samples_v, samples_w), lists of (N,) tensors matching the
    grid lists; `valid` masks samples to 0 (out of domain -> 0,
    macvelocityfield.cpp:353-378)."""
    comp_grids = {"u": grids_u, "v": grids_v, "w": grids_w}
    columns = []
    layout = {}
    for comp in "uvw":
        for gi, grid in enumerate(comp_grids[comp]):
            for o in itertools.product(*_windows(comp)):
                layout[(comp, gi, o)] = len(columns)
                columns.append(shifted_read(grid, o, grid_shape).reshape(-1))
    vals = rows_at_cells(columns, keys)
    del columns

    home = decode_cells(keys, grid_shape)
    ps = (px, py, pz)
    outs = {"u": [], "v": [], "w": []}
    for comp in "uvw":
        off = _MAC_OFFSETS[comp]
        fs, deltas = [], []
        for ax in range(3):
            f = ps[ax] / dx - off[ax]
            b = torch.floor(f)
            fs.append(f - b)
            deltas.append(b.to(torch.int64) - home[ax])
        for gi in range(len(comp_grids[comp])):
            out = torch.zeros_like(px)
            for o in itertools.product(*_windows(comp)):
                w = torch.ones_like(px)
                for ax in range(3):
                    corner = o[ax] - deltas[ax]
                    w = w * torch.where(
                        corner == 0, 1.0 - fs[ax],
                        torch.where(corner == 1, fs[ax],
                                    torch.zeros_like(fs[ax])))
                out = out + w * vals[layout[(comp, gi, o)]]
            if valid is not None:
                out = torch.where(valid, out, torch.zeros_like(out))
            outs[comp].append(out)
    return outs["u"], outs["v"], outs["w"]


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
