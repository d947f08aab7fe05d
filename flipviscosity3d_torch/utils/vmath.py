"""Vector / 3x3-matrix / quaternion math over batched tensors.

Counterpart of flipviscosity3d_tpu/utils/vmath.py (the reference's vmath
namespace, vmath.h:39-225): vec3 dot/cross/length/normalize, mat3 products
and transpose, and quaternions (axis-angle construction, Hamilton product
-- the reference calls it `cross` -- normalization, and rotation-matrix
cast, vmath.h:166-225). The simulator itself never calls mat3/quat; the
module exists for API completeness, on plain tensors:
    vec3  -> float32[..., 3]
    mat3  -> float32[..., 3, 3]   (row-major rows, m @ v semantics)
    quat  -> float32[..., 4]      as (w, x, y, z)
"""

from __future__ import annotations

import torch

# ---------------- vec3 ----------------


def dot(a, b):
    return (a * b).sum(dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def lengthsq(a):
    return (a * a).sum(dim=-1)


def length(a):
    return torch.sqrt(lengthsq(a))


def normalize(a, eps: float = 0.0):
    """v / |v|; `eps` guards the zero vector (the reference divides by the
    raw length, vmath.h:95-98 -- pass eps=0 for exact parity)."""
    n = length(a)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return a / n


def equals(a, b, eps):
    return ((a - b).abs() <= eps).all(dim=-1)


# ---------------- mat3 ----------------


def mat3_identity(dtype=torch.float32, device=None):
    return torch.eye(3, dtype=dtype, device=device)


def mat3_mult(m1, m2):
    """Matrix product (vmath.h:126, operator*(mat3, mat3))."""
    return m1 @ m2


def mat3_vec(m, v):
    """m @ v (vmath.h:127, operator*(mat3, vec3))."""
    return torch.einsum("...ij,...j->...i", m, v)


def transpose(m):
    return m.transpose(-1, -2)


def mat3_det(m):
    return torch.linalg.det(m)


def mat3_inverse(m):
    return torch.linalg.inv(m)


# ---------------- quat (w, x, y, z) ----------------


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_from_axis_angle(rads, axis):
    """quat(rads, v): rotation of `rads` about `axis` (vmath.h quat ctor;
    axis is normalized like the reference's usage assumes)."""
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32))
    rads = torch.as_tensor(rads, dtype=axis.dtype, device=axis.device)
    half = 0.5 * rads
    xyz = axis * torch.sin(half)[..., None]
    w = torch.cos(half)[..., None].expand(xyz.shape[:-1] + (1,))
    return torch.cat([w, xyz], dim=-1)


def quat_normalize(q):
    """(vmath.h:194-207)"""
    return q / torch.sqrt((q * q).sum(dim=-1))[..., None]


def quat_mult(q1, q2):
    """Hamilton product -- the reference names this `cross(quat, quat)`
    (vmath.h:209-225): scalar = s1*s2 - v1.v2, vector = s1*v2 + s2*v1 + v1xv2.
    """
    s1, v1 = q1[..., :1], q1[..., 1:]
    s2, v2 = q2[..., :1], q2[..., 1:]
    scalar = s1 * s2 - dot(v1, v2)[..., None]
    vect = s1 * v2 + s2 * v1 + cross(v1, v2)
    return torch.cat([scalar, vect], dim=-1)


def quat_to_mat3(q):
    """mat3_cast (vmath.h:181-192), as the standard row-major rotation
    matrix R with R @ v rotating v."""
    w, x, y, z = q.unbind(dim=-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_rotate(q, v):
    """Rotate vec3 v by unit quaternion q."""
    return mat3_vec(quat_to_mat3(q), v)
