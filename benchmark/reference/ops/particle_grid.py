"""Dense particle<->grid transfers over (capacity, n_cells) slot tables.

Counterpart of flipviscosity3d_tpu/ops/particle_grid.py: the "table"
engine's transfers, and the liquid SDF sweep that the "pallas" engine runs
over its own slot table. Every function works on a BucketTable
(ops/buckets.py) whose first three fields are the slot positions (far away
in empty slots), as dense per-offset reductions plus static shifted slices
of the grids; the float expressions are the JAX package's, in its order.

Reference semantics:
- liquid SDF from particle spheres over the 3x3x3 window
  (particlelevelset.cpp:98-139);
- P2G with the Wyvill kernel, weight-normalized (fluidsimulation.cpp:364-438);
  the kernel radius dx gives weight only to the 2^3 faces around
  floor((p - offset) / dx), so the window relative to the home cell is {0,1}
  on the component axis and {-1,0,1} across it;
- trilinear MAC sampling with half-dx transverse shifts, out of domain -> 0
  (macvelocityfield.cpp:455-578);
- solid SDF pushback along the interpolated gradient
  (fluidsimulation.cpp:326-333, interpolation.cpp:122-184).
"""

from __future__ import annotations

import itertools

import torch

from .buckets import BucketTable, cell_coords
from .grids import shifted_read
from .stream_transfers import (
    _COMP_AXIS,
    _MAC_OFFSETS,
    _wyvill_weight,
    extrapolate_sdf_into_solid,
)


def _component_windows(component):
    """Per-axis face-offset windows relative to the home cell."""
    comp_axis = _COMP_AXIS[component]
    return [(0, 1) if ax == comp_axis else (-1, 0, 1)
            for ax in range(3)], comp_axis


def _positions(table):
    """(px, py, pz) of a BucketTable, or of the (px, py, pz, ...) fields of
    another slot table (the "pallas" engine's pp.table_fields)."""
    fields = table.fields if isinstance(table, BucketTable) else table
    return fields[0], fields[1], fields[2]


def liquid_sdf_from_particles(table, grid_shape, dx, radius,
                              solid_center_phi, finalize=True):
    """Cell-centered liquid SDF (particlelevelset.cpp:77-139): phi(c) =
    min(3dx, min over particles in the 3x3x3 cell window of |center(c) - p|
    - radius), then -dx/2 in solid cells near the surface unless
    `finalize` is False.

    The JAX form builds a (cap, n_cells, 27) broadcast that XLA fuses away;
    here the 27 offsets run as a loop with a running min of d^2 (the JAX
    order: min of d^2, then the root), so no intermediate is larger than
    (cap, n_cells)."""
    px, py, pz = _positions(table)
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
    if not finalize:
        return phi
    return extrapolate_sdf_into_solid(phi, solid_center_phi, dx)


def p2g_and_sdf(table: BucketTable, grid_shape, dx, radius, solid_center_phi,
                face_shapes):
    """Pass A of the table engine: the liquid SDF and all three P2G
    components in one sweep over the 27 cell offsets (the P2G windows are
    subsets of the SDF window). The SDF takes sqrt(d^2) - radius per slot
    and then the min, as the JAX function does.

    Returns (phi, [(val_sum, w_sum) per component])."""
    px, py, pz = _positions(table)
    vels = (table.fields[3], table.fields[4], table.fields[5])
    coords = cell_coords(grid_shape, px.device).to(torch.float32)
    max_dist = 3.0 * dx

    phi = torch.full(grid_shape, max_dist, dtype=torch.float32,
                     device=px.device)
    sums = {c: (torch.zeros(fs, device=px.device),
                torch.zeros(fs, device=px.device))
            for c, fs in zip("uvw", face_shapes)}
    cx = coords[0] * dx
    cy = coords[1] * dx
    cz = coords[2] * dx

    for o in itertools.product((-1, 0, 1), repeat=3):
        neg = tuple(-v for v in o)
        # SDF: distance from the slot particles to the offset cell center
        dxp = cx[None, :] + (o[0] + 0.5) * dx - px
        dyp = cy[None, :] + (o[1] + 0.5) * dx - py
        dzp = cz[None, :] + (o[2] + 0.5) * dx - pz
        d = torch.sqrt(dxp * dxp + dyp * dyp + dzp * dzp) - radius
        del dxp, dyp, dzp
        m = d.min(dim=0).values.reshape(grid_shape)
        del d
        phi = torch.minimum(
            phi, shifted_read(m, neg, grid_shape, fill=float("inf")))

        # P2G: the components whose window holds this offset
        for ci, comp in enumerate("uvw"):
            if o[_COMP_AXIS[comp]] not in (0, 1):
                continue
            off = _MAC_OFFSETS[comp]
            fx = cx[None, :] + o[0] * dx - (px - off[0] * dx)
            fy = cy[None, :] + o[1] * dx - (py - off[1] * dx)
            fz = cz[None, :] + o[2] * dx - (pz - off[2] * dx)
            d2 = fx * fx + fy * fy + fz * fz
            del fx, fy, fz
            w = _wyvill_weight(d2, dx)
            del d2
            wv = (w * vels[ci]).sum(dim=0).reshape(grid_shape)
            ws = w.sum(dim=0).reshape(grid_shape)
            del w
            vs_, ss_ = sums[comp]
            sums[comp] = (vs_ + shifted_read(wv, neg, face_shapes[ci]),
                          ss_ + shifted_read(ws, neg, face_shapes[ci]))

    phi = extrapolate_sdf_into_solid(phi, solid_center_phi, dx)
    return phi, [sums[c] for c in "uvw"]


def p2g_component(table: BucketTable, vel_field, grid_shape, dx, component,
                  face_shape):
    """Scatter one velocity component to its face grid with Wyvill weights.
    vel_field: (capacity, n_cells) table of this component's values.
    Returns (value_sum, weight_sum) of `face_shape`."""
    px, py, pz = _positions(table)
    off = _MAC_OFFSETS[component]
    windows, _ = _component_windows(component)
    coords = cell_coords(grid_shape, px.device).to(torch.float32)

    # the slot positions in the component's shifted frame
    sx = px - off[0] * dx
    sy = py - off[1] * dx
    sz = pz - off[2] * dx

    val_sum = torch.zeros(face_shape, device=px.device)
    w_sum = torch.zeros(face_shape, device=px.device)
    for o in itertools.product(*windows):
        dxp = (coords[0] + o[0]) * dx - sx
        dyp = (coords[1] + o[1]) * dx - sy
        dzp = (coords[2] + o[2]) * dx - sz
        d2 = dxp * dxp + dyp * dyp + dzp * dzp
        w = _wyvill_weight(d2, dx)
        wv = (w * vel_field).sum(dim=0).reshape(grid_shape)
        ws = w.sum(dim=0).reshape(grid_shape)
        # face c + o receives cell c's sums
        neg = tuple(-v for v in o)
        val_sum = val_sum + shifted_read(wv, neg, face_shape)
        w_sum = w_sum + shifted_read(ws, neg, face_shape)
    return val_sum, w_sum


def _cell_shape_of(grid, component):
    """The cell grid's shape from a face grid's."""
    s = list(grid.shape)
    s[_COMP_AXIS[component]] -= 1
    return tuple(s)


def g2p_component(table: BucketTable, grids, dx, component, in_domain=None):
    """One MAC component of several grids sampled at every slot position;
    all grids share the trilinear weights (the new and the FLIP-saved
    fields). Positions out of the domain sample to 0 where `in_domain`
    ((capacity, n_cells) bool) is given. Returns a list of
    (capacity, n_cells) tensors.

    The home-cell deltas are int64: an empty slot's position (1e8) over dx
    overflows int32 (the JAX package's int32 cast of it is meaningless);
    empty slots are never read back."""
    px, py, pz = _positions(table)
    grid_shape = _cell_shape_of(grids[0], component)
    off = _MAC_OFFSETS[component]
    windows, _ = _component_windows(component)
    coords = cell_coords(grid_shape, px.device)

    fs, deltas = [], []
    for ax, p in enumerate((px, py, pz)):
        f = p / dx - off[ax]
        b = torch.floor(f)
        fs.append(f - b)   # t in [0, 1)
        deltas.append(b.to(torch.int64) - coords[ax][None, :])
        del f, b

    outs = [torch.zeros_like(px) for _ in grids]
    for o in itertools.product(*windows):
        w = torch.ones_like(px)
        for ax in range(3):
            corner = o[ax] - deltas[ax]
            w = w * torch.where(
                corner == 0, 1.0 - fs[ax],
                torch.where(corner == 1, fs[ax], torch.zeros_like(fs[ax])))
            del corner
        for gi, grid in enumerate(grids):
            gv = shifted_read(grid, o, grid_shape).reshape(1, -1)
            outs[gi] = outs[gi] + w * gv
    if in_domain is not None:
        outs = [torch.where(in_domain, v, torch.zeros_like(v)) for v in outs]
    return outs


def sample_mac_at_table(table: BucketTable, u, v, w, dx, in_domain=None):
    """The full MAC velocity at every slot -> (vx, vy, vz) tables."""
    (vx,) = g2p_component(table, [u], dx, "u", in_domain)
    (vy,) = g2p_component(table, [v], dx, "v", in_domain)
    (vz,) = g2p_component(table, [w], dx, "w", in_domain)
    return vx, vy, vz


def solid_phi_and_gradient_at_table(table: BucketTable, phi_node, dx,
                                    grid_shape):
    """Solid SDF value and trilinear gradient at in-domain slot positions
    (home cell == floor(p / dx), so the 8 corners are the home cell's nodes;
    interpolation.cpp:122-184)."""
    px, py, pz = _positions(table)
    coords = cell_coords(grid_shape, px.device)
    tx, ty, tz = (p / dx - coords[ax][None, :].to(torch.float32)
                  for ax, p in enumerate((px, py, pz)))
    corner = {o: shifted_read(phi_node, o, grid_shape).reshape(1, -1)
              for o in itertools.product((0, 1), repeat=3)}

    def lerp(a, b, t):
        return (1.0 - t) * a + t * b

    def bilerp(v00, v10, v01, v11, s, t):
        return lerp(lerp(v00, v10, s), lerp(v01, v11, s), t)

    c = corner
    phi = lerp(
        bilerp(c[0, 0, 0], c[0, 1, 0], c[0, 0, 1], c[0, 1, 1], ty, tz),
        bilerp(c[1, 0, 0], c[1, 1, 0], c[1, 0, 1], c[1, 1, 1], ty, tz),
        tx,
    )
    gx = bilerp(c[1, 0, 0] - c[0, 0, 0], c[1, 1, 0] - c[0, 1, 0],
                c[1, 0, 1] - c[0, 0, 1], c[1, 1, 1] - c[0, 1, 1], ty, tz)
    gy = bilerp(c[0, 1, 0] - c[0, 0, 0], c[1, 1, 0] - c[1, 0, 0],
                c[0, 1, 1] - c[0, 0, 1], c[1, 1, 1] - c[1, 0, 1], tx, tz)
    gz = bilerp(c[0, 0, 1] - c[0, 0, 0], c[1, 0, 1] - c[1, 0, 0],
                c[0, 1, 1] - c[0, 1, 0], c[1, 1, 1] - c[1, 1, 0], tx, ty)
    return phi, (gx, gy, gz)


def solid_pushback_displacement(table: BucketTable, phi_node, dx, grid_shape):
    """Per-slot displacement projecting penetrating particles out of solids
    (fluidsimulation.cpp:326-333): if phi < 0, p -= phi * normalize(grad
    phi)."""
    phi, (gx, gy, gz) = solid_phi_and_gradient_at_table(table, phi_node, dx,
                                                        grid_shape)
    len2 = gx * gx + gy * gy + gz * gz
    inv = torch.where(len2 > 0,
                      1.0 / torch.sqrt(torch.clamp(len2, min=1e-30)),
                      torch.ones_like(len2))
    scale = torch.where(phi < 0, -phi * inv, torch.zeros_like(phi))
    return scale * gx, scale * gy, scale * gz
