"""Axis-aligned bounding boxes (API parity with the reference's AABB,
aabb.h:33-61, aabb.cpp:25-234). Plain numpy, a copy of
flipviscosity3d_tpu/utils/aabb.py.

Array-friendly: every query broadcasts over (..., 3) point arrays. The
simulation core inlines the two operations it needs (expand + nearest-point
clamp) as fused arithmetic; this class serves scene-setup code and users of
the reference API.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AABB:
    position: np.ndarray  # min corner (3,)
    width: float
    height: float
    depth: float

    @classmethod
    def from_extents(cls, x, y, z, w, h, d) -> "AABB":
        return cls(np.asarray([x, y, z], np.float64), float(w), float(h), float(d))

    @classmethod
    def from_points(cls, points) -> "AABB":
        """Tight box over points (aabb.cpp AABB(vector<vec3>))."""
        points = np.asarray(points, np.float64).reshape(-1, 3)
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        return cls(lo, *(hi - lo))

    @property
    def extents(self) -> np.ndarray:
        return np.asarray([self.width, self.height, self.depth], np.float64)

    def get_min_point(self) -> np.ndarray:
        return self.position.copy()

    def get_max_point(self) -> np.ndarray:
        return self.position + self.extents

    def expand(self, v: float) -> "AABB":
        """Grow by v/2 on every side (aabb.cpp:118-124); negative shrinks."""
        return AABB(
            self.position - 0.5 * v,
            self.width + v, self.height + v, self.depth + v,
        )

    def is_point_inside(self, p) -> np.ndarray:
        """Half-open containment (aabb.cpp:126-129)."""
        p = np.asarray(p, np.float64)
        lo = self.position
        hi = self.get_max_point()
        return np.all((p >= lo) & (p < hi), axis=-1)

    def nearest_point_inside(self, p, eps: float = 1e-6) -> np.ndarray:
        """Clamp to [min, max - eps] for points outside (aabb.cpp:213-234)."""
        p = np.asarray(p, np.float64)
        inside = self.is_point_inside(p)
        clamped = np.clip(p, self.position, self.get_max_point() - eps)
        return np.where(inside[..., None], p, clamped)

    def is_line_intersecting(self, p1, p2) -> bool:
        """Segment-box separating-axis test (aabb.cpp:131-160)."""
        p1 = np.asarray(p1, np.float64)
        p2 = np.asarray(p2, np.float64)
        lo = self.position
        hi = self.get_max_point()
        d = (p2 - p1) * 0.5
        e = (hi - lo) * 0.5
        c = p1 + d - (lo + hi) * 0.5
        ad = np.abs(d)
        if np.any(np.abs(c) > e + ad):
            return False
        cross_terms = [
            abs(d[1] * c[2] - d[2] * c[1]) > e[1] * ad[2] + e[2] * ad[1],
            abs(d[2] * c[0] - d[0] * c[2]) > e[2] * ad[0] + e[0] * ad[2],
            abs(d[0] * c[1] - d[1] * c[0]) > e[0] * ad[1] + e[1] * ad[0],
        ]
        return not any(cross_terms)
