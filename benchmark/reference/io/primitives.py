"""Procedural primitive meshes.

Stand-ins for the reference's sample_meshes/*.ply scene assets (sphere,
cube, cone, rod, sheet) so scenes can be built without external data files.
All return TriangleMesh with outward-facing triangles. A copy of
flipviscosity3d_tpu/io/primitives.py (plain numpy): the arrays are equal.
"""

from __future__ import annotations

import numpy as np

from .trianglemesh import TriangleMesh, box_mesh

_ICO_T = (1.0 + 5.0 ** 0.5) / 2.0

_ICO_VERTS = np.array(
    [
        (-1, _ICO_T, 0), (1, _ICO_T, 0), (-1, -_ICO_T, 0), (1, -_ICO_T, 0),
        (0, -1, _ICO_T), (0, 1, _ICO_T), (0, -1, -_ICO_T), (0, 1, -_ICO_T),
        (_ICO_T, 0, -1), (_ICO_T, 0, 1), (-_ICO_T, 0, -1), (-_ICO_T, 0, 1),
    ],
    np.float64,
)

_ICO_FACES = [
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
    (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
    (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
]


def sphere(center, radius, subdivisions: int = 3) -> TriangleMesh:
    """Geodesic icosphere."""
    verts = list(_ICO_VERTS)
    faces = list(_ICO_FACES)
    for _ in range(subdivisions):
        cache: dict = {}
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                cache[key] = len(verts)
                verts.append((np.asarray(verts[a]) + np.asarray(verts[b])) / 2)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    v = np.asarray(verts, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return TriangleMesh(
        (np.asarray(center) + radius * v).astype(np.float32),
        np.asarray(faces, np.int32),
    )


def cube(center, size) -> TriangleMesh:
    """Axis-aligned cube of edge length `size`."""
    h = 0.5 * float(size)
    c = np.asarray(center, np.float64)
    return box_mesh(c - h, c + h)


def rod(center, radius, length, axis: int = 0, segments: int = 24) -> TriangleMesh:
    """Capped cylinder along the given axis."""
    c = np.asarray(center, np.float64)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    circle = np.stack([np.cos(ang), np.sin(ang)], axis=1) * radius
    tr = [a for a in range(3) if a != axis]
    verts = []
    for end in (-0.5 * length, 0.5 * length):
        for p in circle:
            v = c.copy()
            v[axis] += end
            v[tr[0]] += p[0]
            v[tr[1]] += p[1]
            verts.append(v)
    lo_center = len(verts)
    v = c.copy(); v[axis] -= 0.5 * length; verts.append(v)
    hi_center = len(verts)
    v = c.copy(); v[axis] += 0.5 * length; verts.append(v)

    tris = []
    n = segments
    for i in range(n):
        j = (i + 1) % n
        # side quad (lo_i, lo_j, hi_j, hi_i)
        tris += [(i, j, n + j), (i, n + j, n + i)]
        # caps
        tris += [(lo_center, j, i), (hi_center, n + i, n + j)]
    return TriangleMesh(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32)
    )


def sheet(center, size_a, size_b, thickness, normal_axis: int = 1) -> TriangleMesh:
    """Thin box slab orthogonal to `normal_axis`."""
    c = np.asarray(center, np.float64)
    half = np.empty(3)
    tr = [a for a in range(3) if a != normal_axis]
    half[normal_axis] = 0.5 * thickness
    half[tr[0]] = 0.5 * size_a
    half[tr[1]] = 0.5 * size_b
    return box_mesh(c - half, c + half)


def cone(center_base, radius, height, axis: int = 1, segments: int = 24) -> TriangleMesh:
    """Cone with base disc at center_base extending +height along axis."""
    c = np.asarray(center_base, np.float64)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    circle = np.stack([np.cos(ang), np.sin(ang)], axis=1) * radius
    tr = [a for a in range(3) if a != axis]
    verts = []
    for p in circle:
        v = c.copy()
        v[tr[0]] += p[0]
        v[tr[1]] += p[1]
        verts.append(v)
    base_center = len(verts)
    verts.append(c.copy())
    apex = len(verts)
    v = c.copy(); v[axis] += height; verts.append(v)
    tris = []
    n = segments
    for i in range(n):
        j = (i + 1) % n
        tris += [(base_center, j, i), (apex, i, j)]
    return TriangleMesh(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32)
    )
