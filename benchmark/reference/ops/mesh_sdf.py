"""Triangle mesh -> signed distance field on grid nodes.

Counterpart of flipviscosity3d_tpu/ops/mesh_sdf.py: the exact brute-force
(node x triangle) distance runs in torch over blocks of nodes and chunks of
triangles; the inside/outside sign keeps the reference's
simulation-of-simplicity ray-parity rule (meshlevelset.cpp:246-266,
331-347, 394-432) in float64 numpy at scene setup. Also the solid-boundary
quantities derived from the node SDF (meshlevelset.cpp:66-194).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .levelset import fraction_inside_quad


def _point_segment_dist_sq(p, a, b):
    """Squared distance from points p (N,3) to segments a-b (M,3) -> (N,M)."""
    d = b - a
    m2 = (d * d).sum(-1)
    t = ((p[:, None, :] - a[None]) * d[None]).sum(-1)
    t = torch.clamp(t / torch.clamp(m2, min=1e-30), 0.0, 1.0)
    diff = p[:, None, :] - (a[None] + t[..., None] * d[None])
    return (diff * diff).sum(-1)


def _point_triangle_dist_sq(p, v1, v2, v3):
    """Squared point-triangle distance, branchless
    (meshlevelset.cpp:350-390): barycentric projection onto the plane, edge
    clamping by which barycentric coordinate is positive."""
    x13 = v1 - v3
    x23 = v2 - v3
    m13 = (x13 * x13).sum(-1)
    m23 = (x23 * x23).sum(-1)
    d = (x13 * x23).sum(-1)
    invdet = 1.0 / torch.clamp(m13 * m23 - d * d, min=1e-30)
    x03 = p[:, None, :] - v3[None]
    a = (x03 * x13[None]).sum(-1)
    b = (x03 * x23[None]).sum(-1)
    w23 = invdet * (m23 * a - d * b)
    w31 = invdet * (m13 * b - d * a)
    w12 = 1.0 - w23 - w31
    proj = (w23[..., None] * v1[None] + w31[..., None] * v2[None]
            + w12[..., None] * v3[None])
    diff = p[:, None, :] - proj
    d_in = (diff * diff).sum(-1)
    d12 = _point_segment_dist_sq(p, v1, v2)
    d13 = _point_segment_dist_sq(p, v1, v3)
    d23 = _point_segment_dist_sq(p, v2, v3)
    inside = (w23 >= 0) & (w31 >= 0) & (w12 >= 0)
    d_out = torch.where(
        w23 > 0, torch.minimum(d12, d13),
        torch.where(w31 > 0, torch.minimum(d12, d23), torch.minimum(d13, d23)))
    return torch.where(inside, d_in, d_out)


def _min_distance_grid(node_shape, dx, tri, device, point_block=65536,
                       chunk=64):
    """Exact min distance from every grid node to any triangle (M,3,3);
    returns a flat tensor of length prod(node_shape)."""
    n = node_shape[0] * node_shape[1] * node_shape[2]
    nj, nk = node_shape[1], node_shape[2]
    out = torch.empty(n, dtype=torch.float32, device=device)
    for lo in range(0, n, point_block):
        q = torch.arange(lo, min(lo + point_block, n), device=device)
        pts = torch.stack([q // (nj * nk), (q // nk) % nj, q % nk],
                          dim=-1).to(torch.float32) * dx
        best = torch.full((q.shape[0],), float("inf"), dtype=torch.float32,
                          device=device)
        for c in range(0, tri.shape[0], chunk):
            t = tri[c:c + chunk]
            d2 = _point_triangle_dist_sq(pts, t[:, 0], t[:, 1], t[:, 2])
            best = torch.minimum(best, d2.min(dim=1).values)
        out[lo:lo + q.shape[0]] = torch.sqrt(best)
    return out


def _orientation(x1, y1, x2, y2):
    """Twice signed area + simulation-of-simplicity sign
    (meshlevelset.cpp:452-469)."""
    area = y1 * x2 - x1 * y2
    sign = np.sign(area)
    tie = sign == 0
    sign = np.where(tie & (y2 > y1), 1.0, sign)
    sign = np.where(tie & (y2 < y1), -1.0, sign)
    tie2 = tie & (y2 == y1)
    sign = np.where(tie2 & (x1 > x2), 1.0, sign)
    sign = np.where(tie2 & (x1 < x2), -1.0, sign)
    return sign, area


def _column_crossing_counts(vertices, triangles, node_shape, dx):
    """Ray-parity intersection counts per (i, j, k) node, numpy float64:
    for each triangle and each integer (j,k) lattice column inside its (y,z)
    bounding box, a crossing at i = ceil(interpolated x/dx)."""
    isz, jsz, ksz = node_shape
    counts = np.zeros(node_shape, np.int64)
    v = np.asarray(vertices, np.float64) / dx
    tris = np.asarray(triangles, np.int64)
    for t0, t1, t2 in tris:
        p, q, r = v[t0], v[t1], v[t2]
        j0 = int(np.clip(np.ceil(min(p[1], q[1], r[1])), 0, jsz - 1))
        j1 = int(np.clip(np.floor(max(p[1], q[1], r[1])), 0, jsz - 1))
        k0 = int(np.clip(np.ceil(min(p[2], q[2], r[2])), 0, ksz - 1))
        k1 = int(np.clip(np.floor(max(p[2], q[2], r[2])), 0, ksz - 1))
        if j1 < j0 or k1 < k0:
            continue
        jj, kk = np.meshgrid(np.arange(j0, j1 + 1), np.arange(k0, k1 + 1),
                             indexing="ij")
        y1, z1 = p[1] - jj, p[2] - kk
        y2, z2 = q[1] - jj, q[2] - kk
        y3, z3 = r[1] - jj, r[2] - kk
        sa, oa = _orientation(y2, z2, y3, z3)
        sb, ob = _orientation(y3, z3, y1, z1)
        sc, oc = _orientation(y1, z1, y2, z2)
        hit = (sa != 0) & (sb == sa) & (sc == sa)
        if not hit.any():
            continue
        total = oa + ob + oc
        with np.errstate(divide="ignore", invalid="ignore"):
            fi = (oa / total) * p[0] + (ob / total) * q[0] + (oc / total) * r[0]
        ii = np.ceil(fi).astype(np.int64)[hit]
        ji, ki = jj[hit], kk[hit]
        lo = ii < 0
        np.add.at(counts, (np.zeros(lo.sum(), np.int64), ji[lo], ki[lo]), 1)
        ok = (~lo) & (ii < isz)
        np.add.at(counts, (ii[ok], ji[ok], ki[ok]), 1)
    return counts


@dataclasses.dataclass
class MeshLevelSet:
    """Node-sampled signed distance field: phi has shape
    (isize+1, jsize+1, ksize+1); negative inside the mesh."""

    phi: torch.Tensor
    dx: float

    def negate(self) -> "MeshLevelSet":
        """CSG complement (meshlevelset.cpp:186-194)."""
        return MeshLevelSet(-self.phi, self.dx)

    def union(self, other: "MeshLevelSet") -> "MeshLevelSet":
        """CSG union = elementwise min (meshlevelset.cpp:152-184)."""
        return MeshLevelSet(torch.minimum(self.phi, other.phi), self.dx)

    def cell_center_phi(self) -> torch.Tensor:
        """Average of the 8 surrounding nodes (meshlevelset.cpp:66-76)."""
        p = self.phi
        return 0.125 * (
            p[:-1, :-1, :-1] + p[1:, :-1, :-1] + p[:-1, 1:, :-1]
            + p[1:, 1:, :-1] + p[:-1, :-1, 1:] + p[1:, :-1, 1:]
            + p[:-1, 1:, 1:] + p[1:, 1:, 1:])

    def face_weight_u(self) -> torch.Tensor:
        """2D inside-fraction on every U face (meshlevelset.cpp:92-98)."""
        p = self.phi
        return fraction_inside_quad(p[:, :-1, :-1], p[:, 1:, :-1],
                                    p[:, :-1, 1:], p[:, 1:, 1:])

    def face_weight_v(self) -> torch.Tensor:
        """(meshlevelset.cpp:104-110)."""
        p = self.phi
        return fraction_inside_quad(p[:-1, :, :-1], p[:-1, :, 1:],
                                    p[1:, :, :-1], p[1:, :, 1:])

    def face_weight_w(self) -> torch.Tensor:
        """(meshlevelset.cpp:116-122)."""
        p = self.phi
        return fraction_inside_quad(p[:-1, :-1, :], p[:-1, 1:, :],
                                    p[1:, :-1, :], p[1:, 1:, :])


def mesh_to_sdf(vertices, triangles, grid_shape, dx, device) -> MeshLevelSet:
    """Signed distance field of a triangle mesh on the (I+1,J+1,K+1) nodes:
    exact distances everywhere, signs by the reference's ray-parity rule."""
    node_shape = tuple(s + 1 for s in grid_shape)
    verts = np.asarray(vertices, np.float32)
    tris = np.asarray(triangles, np.int64)
    tv = torch.from_numpy(verts[tris]).to(device)
    dist = _min_distance_grid(node_shape, dx, tv, device).reshape(node_shape)
    counts = _column_crossing_counts(verts, tris, node_shape, dx)
    inside = torch.from_numpy(
        (np.cumsum(counts, axis=0) % 2) == 1).to(device)
    return MeshLevelSet(torch.where(inside, -dist, dist), float(dx))
