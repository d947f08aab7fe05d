"""Matrix-free preconditioned conjugate gradient over tuples of grids.

The CG structure of the reference (pressuresolver.cpp:521-567) as in the
JAX package's solvers/pcg.py, with the while loop on the host: the
convergence test `(res > tol) & (it < max_iterations)` is read from the card
once per iteration, in the same order, so iteration counts can match.
Operands are tuples of grids (one for pressure, (u, v, w) for viscosity).
The slab pipeline (parallel/shard_step.py) passes its rank's `group` and a
`reduce_mask` of owned rows: the dots and the inf-norm then cover owned rows
only and are summed / maxed over the ranks, so every rank holds the same
values and takes the same branch of the loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _dot(a, b, group=None, mask=None):
    d = 0.0
    if mask is None:
        for x, y in zip(a, b):
            d = d + torch.dot(x.reshape(-1), y.reshape(-1))
    else:
        # where, not a product: halo rows may hold inf / NaN
        for x, y, m in zip(a, b, mask):
            xy = x * y
            d = d + torch.where(m > 0, xy, torch.zeros_like(xy)).sum()
    return d if group is None else group.psum(d)


def _absmax(a, group=None, mask=None):
    if mask is None:
        m = torch.stack([x.abs().max() for x in a]).max()
    else:
        m = torch.stack([
            torch.where(mm > 0, x.abs(), torch.zeros_like(x)).max()
            for x, mm in zip(a, mask)]).max()
    return m if group is None else group.pmax(m)


def _axpy(alpha, x, y):
    return tuple(yi + alpha * xi for xi, yi in zip(x, y))


@dataclasses.dataclass
class PCGResult:
    x: tuple                 # solution, a tuple of grids
    iterations: int
    residual: torch.Tensor   # final inf-norm of the residual (0-d, f32)
    converged: bool
    tol: torch.Tensor        # the absolute tolerance (0-d, f32)


def pcg(apply_A: Callable, b: tuple, apply_M: Callable, tol,
        max_iterations: int, x0: tuple | None = None, group=None,
        reduce_mask: tuple | None = None) -> PCGResult:
    """Solve A x = b with preconditioned CG; the convergence test is on the
    residual inf-norm against the absolute `tol` (a 0-d f32 tensor). Always
    returns the current iterate; `x0` warm-starts. With a slab `group`, the
    reductions run over the rows where `reduce_mask` (a tuple like b) is
    > 0, summed / maxed over the group's ranks; apply_A and apply_M are the
    caller's halo-exchanging operators."""
    if x0 is None:
        x = tuple(torch.zeros_like(bi) for bi in b)
        r = b
    else:
        x = x0
        r = tuple(bi - ai for bi, ai in zip(b, apply_A(x0)))
    s = apply_M(r)
    sigma = _dot(s, r, group, reduce_mask)
    res = _absmax(r, group, reduce_mask)
    it = 0
    while bool(res > tol) and it < max_iterations:
        As = apply_A(s)
        denom = _dot(s, As, group, reduce_mask)
        alpha = sigma / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = _axpy(alpha, s, x)
        r = _axpy(-alpha, As, r)
        z = apply_M(r)
        sigma_new = _dot(z, r, group, reduce_mask)
        beta = sigma_new / torch.where(
            sigma == 0, torch.ones_like(sigma), sigma)
        s = _axpy(beta, s, z)
        sigma = sigma_new
        res = _absmax(r, group, reduce_mask)
        it += 1
    return PCGResult(x, it, res, bool(res <= tol), tol)


def jacobi_preconditioner(diag: tuple):
    """M^-1 = 1/diag elementwise, zero where diag == 0 (off-mask)."""

    def apply_M(r):
        return tuple(
            torch.where(di > 0, ri / torch.where(di == 0,
                                                 torch.ones_like(di), di),
                        torch.zeros_like(ri))
            for ri, di in zip(r, diag))

    return apply_M
