"""Grid interpolation with the reference's conventions, the counterpart of
the JAX package's ops/interp.py (interpolation.cpp:32-184, grid3d.h:37-113,
macvelocityfield.cpp:353-578, particlelevelset.cpp:88-92):

- grid index of a position: floor(pos / dx) per axis
- node (i,j,k) sits at (i*dx, j*dx, k*dx); cell centers at +dx/2
- trilinear sampling gathers the 8 surrounding nodes; out-of-range corners
  contribute 0 (no clamping)
- cell-centered fields (liquid phi) are sampled at pos - dx/2
- MAC velocity components are sampled with the half-dx offsets applied to
  the two transverse axes, and evaluate to exactly 0 for positions outside
  the domain box [0, I*dx) x [0, J*dx) x [0, K*dx)

Gather-based; seeding uses `trilinear`, the substep's hot path uses the
kernels of pallas_particles.py."""

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


def _corners(grid, pos, dx):
    """((di, dj, dk) -> corner value), fractional coordinates t (..., 3)."""
    f = pos / dx
    base = torch.floor(f)
    t = f - base
    base = base.to(torch.int64)
    v = {}
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                off = torch.tensor([di, dj, dk], device=pos.device)
                v[(di, dj, dk)] = gather_grid(grid, base + off)
    return v, t


def trilinear_gradient(grid, pos, dx):
    """Trilinear-interpolated gradient (interpolation.cpp:122-184): corner
    differences along each axis, bilinearly interpolated in the two
    transverse fractional coordinates. Returns (..., 3)."""
    v, t = _corners(grid, pos, dx)

    def bilerp(v00, v10, v01, v11, ix, iy):
        return ((1 - iy) * ((1 - ix) * v00 + ix * v10)
                + iy * ((1 - ix) * v01 + ix * v11))

    # d[a][b] with (a, b) the two transverse corner offsets in axis order
    ddx = [[v[(1, a, b)] - v[(0, a, b)] for b in (0, 1)] for a in (0, 1)]
    gx = bilerp(ddx[0][0], ddx[1][0], ddx[0][1], ddx[1][1],
                t[..., 1], t[..., 2])
    ddy = [[v[(a, 1, b)] - v[(a, 0, b)] for b in (0, 1)] for a in (0, 1)]
    gy = bilerp(ddy[0][0], ddy[1][0], ddy[0][1], ddy[1][1],
                t[..., 0], t[..., 2])
    ddz = [[v[(a, b, 1)] - v[(a, b, 0)] for b in (0, 1)] for a in (0, 1)]
    gz = bilerp(ddz[0][0], ddz[1][0], ddz[0][1], ddz[1][1],
                t[..., 0], t[..., 1])
    return torch.stack([gx, gy, gz], dim=-1)


def sample_liquid_phi(phi_cell, pos, dx):
    """Cell-centered liquid SDF sample (particlelevelset.cpp:88-92):
    trilinear at pos - dx/2."""
    return trilinear(phi_cell, pos - 0.5 * dx, dx)


def sample_solid_phi(phi_node, pos, dx):
    """Node-sampled solid SDF sample (meshlevelset.cpp:82-84)."""
    return trilinear(phi_node, pos, dx)


def sample_solid_phi_gradient(phi_node, pos, dx):
    """Gradient of the node-sampled solid SDF (meshlevelset.cpp:86-90)."""
    return trilinear_gradient(phi_node, pos, dx)


def in_grid(pos, dx, grid_shape):
    """Grid3d::isPositionInGrid (grid3d.h:139-152): pos in [0, size*dx) per
    axis."""
    ext = torch.tensor([s * dx for s in grid_shape], dtype=pos.dtype,
                       device=pos.device)
    return ((pos >= 0) & (pos < ext)).all(dim=-1)


_MAC_OFFSETS = {
    "u": (0.0, 0.5, 0.5),
    "v": (0.5, 0.0, 0.5),
    "w": (0.5, 0.5, 0.0),
}


def _mac_offset(component, pos, dx):
    return torch.tensor(_MAC_OFFSETS[component], dtype=pos.dtype,
                        device=pos.device) * dx


def sample_mac_component(grid, pos, dx, grid_shape, component):
    """One MAC component, linear (macvelocityfield.cpp:455-546): the
    transverse axes are shifted by -dx/2 before the floor; positions outside
    the domain evaluate to 0."""
    val = trilinear(grid, pos - _mac_offset(component, pos, dx), dx)
    return torch.where(in_grid(pos, dx, grid_shape), val,
                       torch.zeros_like(val))


def sample_mac_linear(u, v, w, pos, dx, grid_shape):
    """Full MAC velocity at positions, trilinear
    (macvelocityfield.cpp:564-578). Returns (..., 3)."""
    return torch.stack(
        [sample_mac_component(g, pos, dx, grid_shape, c)
         for g, c in ((u, "u"), (v, "v"), (w, "w"))], dim=-1)


def _cubic(p0, p1, p2, p3, x):
    """Catmull-Rom style cubic (interpolation.cpp:50-52)."""
    return p1 + 0.5 * x * (
        p2 - p0 + x * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3
                       + x * (3.0 * (p1 - p2) + p3 - p0)))


def tricubic(grid, pos, dx):
    """Tricubic sample over a 4^3 neighborhood (interpolation.cpp:32-48 via
    macvelocityfield.cpp:353-385: ref corner = floor(pos/dx) - 1,
    out-of-range points read 0)."""
    f = pos / dx
    base = torch.floor(f)
    t = f - base
    base = base.to(torch.int64)
    zs = []
    for pk in range(4):
        ys = []
        for pj in range(4):
            xs = [gather_grid(grid, base + torch.tensor(
                [pi - 1, pj - 1, pk - 1], device=pos.device))
                for pi in range(4)]
            ys.append(_cubic(*xs, t[..., 0]))
        zs.append(_cubic(*ys, t[..., 1]))
    return _cubic(*zs, t[..., 2])


def sample_mac_cubic(u, v, w, pos, dx, grid_shape):
    """Full MAC velocity, tricubic (macvelocityfield.cpp:548-562)."""
    inside = in_grid(pos, dx, grid_shape)
    comps = []
    for grid, component in ((u, "u"), (v, "v"), (w, "w")):
        val = tricubic(grid, pos - _mac_offset(component, pos, dx), dx)
        comps.append(torch.where(inside, val, torch.zeros_like(val)))
    return torch.stack(comps, dim=-1)
