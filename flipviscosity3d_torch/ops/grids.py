"""Static shifted-slice primitives for stencil and staggered-grid transfers.

The same two operations as the JAX package's ops/grids.py, on tensors with
any number of leading batch axes: the last three axes are spatial.
"""

from __future__ import annotations

import torch


def shifted_read(src, offset, out_shape, fill=0.0):
    """out[c] = src[c + offset] on the last three axes, `fill` where
    c + offset is out of range. `offset` is a static (oi, oj, ok) tuple and
    `out_shape` the spatial output shape; leading axes pass through."""
    lead = tuple(src.shape[:-3])
    out = torch.full(lead + tuple(out_shape), fill, dtype=src.dtype,
                     device=src.device)
    dst_sl, src_sl = [], []
    for ax in range(3):
        o = int(offset[ax])
        n_out = out_shape[ax]
        n_src = src.shape[src.ndim - 3 + ax]
        lo = max(0, -o)
        hi = max(min(n_out, n_src - o), lo)
        dst_sl.append(slice(lo, hi))
        src_sl.append(slice(lo + o, hi + o))
    if all(s.stop > s.start for s in dst_sl):
        out[(...,) + tuple(dst_sl)] = src[(...,) + tuple(src_sl)]
    return out


def interior_mask(shape, device=None):
    """True strictly inside the array (False on all border planes)."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[1:-1, 1:-1, 1:-1] = True
    return m


def range_mask(shape, lo, hi, device=None):
    """True where lo[ax] <= index < hi[ax] on every axis (static)."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
    return m


def _face_borders(fluid, axis):
    pad_shape = list(fluid.shape)
    pad_shape[axis] = 1
    pad = torch.zeros(pad_shape, dtype=torch.bool, device=fluid.device)
    return (torch.cat([pad, fluid], dim=axis)
            | torch.cat([fluid, pad], dim=axis))


def face_borders_fluid_u(fluid):
    """U face (i,j,k) borders a fluid cell (grid3d.h:497-501).
    fluid: (I,J,K) bool -> (I+1,J,K)."""
    return _face_borders(fluid, 0)


def face_borders_fluid_v(fluid):
    return _face_borders(fluid, 1)


def face_borders_fluid_w(fluid):
    return _face_borders(fluid, 2)
