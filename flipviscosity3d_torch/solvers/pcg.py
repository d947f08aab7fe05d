"""Matrix-free preconditioned conjugate gradient over tuples of grids.

The CG structure of the reference (pressuresolver.cpp:521-567) as in the
JAX package's solvers/pcg.py, with the while loop on the host: the
convergence test `(res > tol) & (it < max_iterations)` is read from the card
once per iteration, in the same order, so iteration counts can match.
Operands are tuples of grids (one for pressure, (u, v, w) for viscosity).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _dot(a, b):
    d = 0.0
    for x, y in zip(a, b):
        d = d + torch.dot(x.reshape(-1), y.reshape(-1))
    return d


def _absmax(a):
    return torch.stack([x.abs().max() for x in a]).max()


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
        max_iterations: int, x0: tuple | None = None) -> PCGResult:
    """Solve A x = b with preconditioned CG; the convergence test is on the
    residual inf-norm against the absolute `tol` (a 0-d f32 tensor). Always
    returns the current iterate; `x0` warm-starts."""
    if x0 is None:
        x = tuple(torch.zeros_like(bi) for bi in b)
        r = b
    else:
        x = x0
        r = tuple(bi - ai for bi, ai in zip(b, apply_A(x0)))
    s = apply_M(r)
    sigma = _dot(s, r)
    res = _absmax(r)
    it = 0
    while bool(res > tol) and it < max_iterations:
        As = apply_A(s)
        denom = _dot(s, As)
        alpha = sigma / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = _axpy(alpha, s, x)
        r = _axpy(-alpha, As, r)
        z = apply_M(r)
        sigma_new = _dot(z, r)
        beta = sigma_new / torch.where(
            sigma == 0, torch.ones_like(sigma), sigma)
        s = _axpy(beta, s, z)
        sigma = sigma_new
        res = _absmax(r)
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
