"""Halo exchange and halo fold of the i-axis slab decomposition.

Counterpart of flipviscosity3d_tpu/parallel/halo.py over a SlabGroup
(parallel/collectives.py). Every rank holds a (B + 2*halo, ...) slab of each
global (I, ...) array (B = I // n), rows [halo, B + halo) its own:

- halo_exchange refreshes the halo rows from the face neighbours, before a
  stencil reads shifted values;
- halo_reduce folds what a rank accumulated into its halo rows onto their
  owners (sum, or min), after a scatter-shaped operation (P2G sums, the
  particle SDF's mins), and resets the halo rows.

Boundary ranks take a caller's fill value for their out-of-domain halo
rows (the out-of-range default of ops/grids.shifted_read at the global
border).
"""

from __future__ import annotations

import torch

from .collectives import ring


def halo_exchange(x, group, halo: int, fill=0.0):
    """x (B + 2*halo, ...) with rows [0, halo) set to the left neighbour's
    last owned rows and rows [B + halo, B + 2*halo) to the right
    neighbour's first ones; the domain's boundary ranks get `fill`."""
    return halo_exchange_many([x], group, halo, [fill])[0]


def halo_exchange_many(xs, group, halo: int, fills):
    """halo_exchange of several slabs (fills[i] for xs[i]) in one round."""
    if halo == 0:
        return list(xs)
    n, rank = group.size, group.rank
    items = []
    for x in xs:
        items += [(x[-2 * halo:-halo], ring(n, +1)),    # last owned -> right
                  (x[halo:2 * halo], ring(n, -1))]      # first owned -> left
    got = group.ppermute_many(items)
    out = []
    for i, (x, fill) in enumerate(zip(xs, fills)):
        from_left, from_right = got[2 * i], got[2 * i + 1]
        if rank == 0:
            from_left = torch.full_like(from_left, fill)
        if rank == n - 1:
            from_right = torch.full_like(from_right, fill)
        out.append(torch.cat([from_left, x[halo:-halo], from_right], dim=0))
    return out


def halo_reduce(x, group, halo: int, op: str = "sum", reset=0.0):
    """Fold the halo rows' contributions onto the owning neighbours: rows
    [0, halo) belong to the left neighbour's last owned rows, rows
    [B + halo, B + 2*halo) to the right one's first. Combines what arrives
    into the owned rows (sum or min) and sets the halo rows to `reset`.
    When B < 2*halo the two incoming windows overlap; both combine into
    the shared rows, the left one first."""
    return halo_reduce_many([x], group, halo, [op], [reset])[0]


def halo_reduce_many(xs, group, halo: int, ops, resets):
    """halo_reduce of several slabs (ops[i], resets[i] for xs[i]) in one
    round."""
    for op in ops:
        if op not in ("sum", "min"):
            raise ValueError(op)
    if halo == 0:
        return list(xs)
    n, rank = group.size, group.rank
    items = []
    for x in xs:
        items += [(x[:halo], ring(n, -1)), (x[-halo:], ring(n, +1))]
    got = group.ppermute_many(items)
    out = []
    for i, (x, op, reset) in enumerate(zip(xs, ops, resets)):
        from_right, from_left = got[2 * i], got[2 * i + 1]
        # boundary ranks receive zeros (harmless for sum); min takes reset
        if op == "min":
            if rank == 0:
                from_left = torch.full_like(from_left, reset)
            if rank == n - 1:
                from_right = torch.full_like(from_right, reset)
        rows = x.shape[0]
        y = x.clone()
        y[:halo] = reset
        y[-halo:] = reset
        lo, hi = y[halo:2 * halo], y[rows - 2 * halo:rows - halo]
        if op == "sum":
            lo += from_left
            hi += from_right
        else:
            torch.minimum(lo, from_left, out=lo)
            torch.minimum(hi, from_right, out=hi)
        out.append(y)
    return out


def slab(x_global, group, n: int, halo: int, fill=0.0, owned=None):
    """The (B + 2*halo, ...) slab of this rank from a replicated global
    array: B = x.shape[0] // n unless `owned` gives it; out-of-domain halo
    rows take `fill`."""
    b = owned if owned is not None else x_global.shape[0] // n
    pad = torch.full((halo,) + tuple(x_global.shape[1:]), fill,
                     dtype=x_global.dtype, device=x_global.device)
    padded = torch.cat([pad, x_global, pad], dim=0)
    start = group.rank * b
    return padded[start:start + b + 2 * halo]


def unslab(x_local, halo: int):
    """The owned rows of a local slab."""
    return x_local[halo:x_local.shape[0] - halo] if halo else x_local


def owned_mask_rows(shape0: int, halo: int, dtype=torch.float32,
                    device=None):
    """(shape0,) mask: 1 on owned rows, 0 on halo rows, for reductions that
    must not count a row twice."""
    m = torch.zeros((shape0,), dtype=dtype, device=device)
    m[halo:shape0 - halo] = 1.0
    return m
