"""Triangle meshes: the TriangleMesh container and the 12-triangle box
(pure numpy, copied from flipviscosity3d_tpu/io/trianglemesh.py so that the
port never imports the JAX package). PLY / OBJ / BOBJ I/O is not ported
yet."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TriangleMesh:
    """Vertices (N,3) float32 and triangle vertex indices (M,3) int32."""

    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    triangles: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))

    def aabb(self):
        """(min, max) corner positions over all vertices."""
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


def box_mesh(pmin, pmax) -> TriangleMesh:
    """12-triangle axis-aligned box (FluidSimulation::_getTriangleMeshFromAABB,
    fluidsimulation.cpp:198-223)."""
    x0, y0, z0 = (float(v) for v in pmin)
    x1, y1, z1 = (float(v) for v in pmax)
    verts = np.asarray(
        [
            (x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1),
            (x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1),
        ],
        np.float32,
    )
    tris = np.asarray(
        [
            (0, 1, 2), (0, 2, 3), (4, 7, 6), (4, 6, 5),
            (0, 3, 7), (0, 7, 4), (1, 5, 6), (1, 6, 2),
            (0, 4, 5), (0, 5, 1), (3, 2, 6), (3, 6, 7),
        ],
        np.int32,
    )
    return TriangleMesh(verts, tris)
