"""Galerkin aggregation multigrid V-cycle preconditioner for 7-point blocks.

Counterpart of flipviscosity3d_tpu/solvers/multigrid.py (see its docstring
for why aggregation transfers and the coarse over-correction). With
P = "each fine cell takes its coarse parent's value" over 2x2x2 blocks, the
Galerkin coarse operator P^T A P of a 7-point operator is again 7-point and
is computed in closed form by sum-pooling the fine diagonal and links.

Every level here is (nb, I, J, K): the pressure system has nb = 1, the
viscosity system stacks its three component blocks (nb = 3). The V(1,1)
cycle runs each level above the coarsest as one mg_down and one mg_up
(ops/pallas_mg.py); on the card the level operators are stored in
cfg.mg_operator_dtype, on the CPU in f32. The coarsest level
(min dim <= mg_coarse_size) is solved with an explicit dense inverse.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.grids import shifted_read
from ..ops.pallas_mg import (
    apply_level, inv_diag, mg_down, mg_up, pool_sum, prolong)

_AXES = (0, 1, 2)
_DENSE_COARSE_MAX_CELLS = 4096


def _off(axis, sign):
    o = [0, 0, 0]
    o[axis] = sign
    return tuple(o)


def _shift(x, off3):
    return shifted_read(x, off3, x.shape[-3:])


@dataclasses.dataclass
class MGLevel:
    diag: torch.Tensor
    links: tuple      # per axis: L[c] >= 0 couples c <-> c+ax, A[c,c+ax] = -L[c]
    inv_diag: torch.Tensor


def _level(diag, links):
    return MGLevel(diag, tuple(links), inv_diag(diag))


def _parity_mask(x, spatial_axis):
    """1.0 at odd indices along the spatial axis, broadcastable against x."""
    ax = x.ndim - 3 + spatial_axis
    n = x.shape[ax]
    idx = (torch.arange(n, device=x.device) % 2).to(x.dtype)
    view = [1] * x.ndim
    view[ax] = n
    return idx.reshape(view)


def _coarsen(level: MGLevel) -> MGLevel:
    """Exact Galerkin A_c = P^T A P in closed form."""
    new_links = []
    internal_total = 0.0
    for ax in _AXES:
        L = level.links[ax]
        odd = _parity_mask(L, ax)
        new_links.append(pool_sum(L * odd))
        internal_total = internal_total + pool_sum(L * (1.0 - odd))
    diag_c = pool_sum(level.diag) - 2.0 * internal_total
    return _level(diag_c, new_links)


def _dense_coarse_inverse(level: MGLevel):
    """Batched explicit symmetric inverse (nb, n, n) of the coarsest operator.
    Off-mask rows (diag == 0) get an identity row; a 1e-5 relative diagonal
    shift keeps a pure-Neumann (fully enclosed) coarse operator invertible."""
    nb = level.diag.shape[0]
    spatial = level.diag.shape[-3:]
    n = spatial[0] * spatial[1] * spatial[2]
    dev = level.diag.device
    dflat = level.diag.reshape(nb, n)
    eye = torch.arange(n, device=dev)
    bidx = torch.arange(nb, device=dev)[:, None].expand(nb, n)
    A = torch.zeros((nb, n, n), dtype=level.diag.dtype, device=dev)
    A[:, eye, eye] = torch.where(dflat > 0, dflat * (1.0 + 1e-5),
                                 torch.ones_like(dflat))
    strides = (spatial[1] * spatial[2], spatial[2], 1)
    for ax in _AXES:
        L = level.links[ax].reshape(nb, n)
        j = eye + strides[ax]
        valid = j < n
        jc = torch.where(valid, j, torch.zeros_like(j)).expand(nb, n)
        Lv = torch.where(valid, L, torch.zeros_like(L))
        e = eye.expand(nb, n)
        A.index_put_((bidx, e, jc), -Lv, accumulate=True)
        A.index_put_((bidx, jc, e), -Lv, accumulate=True)
    inv = torch.linalg.inv(A)
    return 0.5 * (inv + inv.transpose(-1, -2))


@dataclasses.dataclass
class MGHierarchy:
    levels: tuple
    coarse_inv: torch.Tensor | None   # None -> smooth the coarsest level
    # per level above the coarsest: (diag, links) in the storage dtype the
    # mg_down / mg_up kernels read (None when the cycle is not V(1,1))
    ops: tuple | None


def _storage_dtype(cfg, device):
    if device.type == "cuda" and cfg.mg_operator_dtype == "bf16":
        return torch.bfloat16
    return torch.float32


def build_hierarchy(diag, links, cfg) -> MGHierarchy:
    """Level hierarchy from the premasked fine operator ((I,J,K) or
    (nb,I,J,K)); coarsening stops once min dim <= mg_coarse_size."""
    if diag.ndim == 3:
        diag = diag[None]
        links = tuple(lk[None] for lk in links)
    levels = [_level(diag, links)]
    for _ in range(cfg.mg_max_levels - 1):
        if min(levels[-1].diag.shape[-3:]) <= cfg.mg_coarse_size:
            break
        levels.append(_coarsen(levels[-1]))
    coarse = levels[-1]
    s = coarse.diag.shape[-3:]
    inv = (_dense_coarse_inverse(coarse)
           if s[0] * s[1] * s[2] <= _DENSE_COARSE_MAX_CELLS else None)
    ops = None
    if (cfg.mg_pre_smooth, cfg.mg_post_smooth) == (1, 1):
        dt = _storage_dtype(cfg, diag.device)
        ops = tuple(
            (lv.diag.to(dt).contiguous(),
             tuple(lk.to(dt).contiguous() for lk in lv.links))
            for lv in levels[:-1])
    return MGHierarchy(tuple(levels), inv, ops)


def _smooth(level: MGLevel, x, b, iters: int, omega: float):
    for _ in range(iters):
        r = b - apply_level(level.diag, level.links, x)
        x = x + omega * level.inv_diag * r
    return x


def _coarse_solve(hier: MGHierarchy, b, pre, post, omega):
    level = hier.levels[-1]
    if hier.coarse_inv is None:
        return _smooth(level, torch.zeros_like(b), b, 2 * (pre + post), omega)
    nb = b.shape[0]
    xf = torch.einsum("bij,bj->bi", hier.coarse_inv, b.reshape(nb, -1))
    return xf.reshape(b.shape)


def v_cycle(hier: MGHierarchy, b, pre: int, post: int, omega: float,
            coarse_scale: float):
    """One V(pre,post) cycle from x = 0 on b ((I,J,K) or (nb,I,J,K)); a
    symmetric linear operator in b. V(1,1) runs through mg_down / mg_up."""
    squeeze = b.ndim == 3
    if squeeze:
        b = b[None]
    levels = hier.levels

    def cycle(lvl: int, b):
        if lvl == len(levels) - 1:
            return _coarse_solve(hier, b, pre, post, omega)
        if hier.ops is not None:
            diag, links = hier.ops[lvl]
            x, rc = mg_down(diag, links, b, omega)
            xc = cycle(lvl + 1, rc)
            return mg_up(diag, links, b, x, xc.contiguous(), omega,
                         coarse_scale)
        level = levels[lvl]
        x = _smooth(level, torch.zeros_like(b), b, pre, omega)
        r = b - apply_level(level.diag, level.links, x)
        xc = cycle(lvl + 1, pool_sum(r))
        x = x + coarse_scale * prolong(xc, b.shape[-3:])
        return _smooth(level, x, b, post, omega)

    out = cycle(0, b.contiguous())
    return out[0] if squeeze else out


def component_links(dir_factors, mask):
    """Undirected link grids of one component's own 7-point block: the '+'
    directional factor gated by both masks."""
    mask_f = mask.to(dir_factors["r"].dtype)
    return tuple(
        dir_factors[k] * mask_f * _shift(mask_f, _off(ax, +1))
        for ax, k in zip(_AXES, ("r", "t", "f"))
    )


def _pad_to(a, spatial):
    pad = []
    for i in (2, 1, 0):
        pad += [0, spatial[i] - a.shape[a.ndim - 3 + i]]
    if any(pad):
        a = torch.nn.functional.pad(a, pad)
    return a


def viscosity_mg_preconditioner(sys, cfg):
    """Block-diagonal V-cycle for the coupled viscosity system: each
    component's own 7-point block, padded to (I+1, J+1, K+1) and stacked on
    one batch axis (padding rows carry zero diagonal and links)."""
    common = (cfg.isize + 1, cfg.jsize + 1, cfg.ksize + 1)
    diags, links3 = [], []
    for c in range(3):
        links = component_links(sys.factors[c], sys.in_mat[c])
        diags.append(_pad_to(sys.diag[c], common))
        links3.append(tuple(_pad_to(L, common) for L in links))
    diag_b = torch.stack(diags)
    links_b = tuple(torch.stack([links3[c][ax] for c in range(3)])
                    for ax in _AXES)
    hier = build_hierarchy(diag_b, links_b, cfg)

    def apply_M(r):
        rb = torch.stack([
            _pad_to(torch.where(m, ri, torch.zeros_like(ri)), common)
            for ri, m in zip(r, sys.in_mat)
        ])
        xb = v_cycle(hier, rb, cfg.mg_pre_smooth, cfg.mg_post_smooth,
                     cfg.mg_omega, cfg.mg_coarse_scale)
        return tuple(
            torch.where(m, xb[c][: m.shape[0], : m.shape[1], : m.shape[2]],
                        torch.zeros_like(xb[c][: m.shape[0], : m.shape[1],
                                               : m.shape[2]]))
            for c, m in enumerate(sys.in_mat)
        )

    return apply_M


def pressure_mg_preconditioner(sys, cfg):
    """V-cycle for the 7-point ghost-fluid pressure system; plus_* grids
    hold A[c, c+ax], gated by the row mask on both sides."""
    fluid_f = sys.fluid.to(sys.diag.dtype)
    links = tuple(
        (-plus) * fluid_f * _shift(fluid_f, _off(ax, +1))
        for ax, plus in zip(_AXES, (sys.plus_i, sys.plus_j, sys.plus_k))
    )
    zero = torch.zeros_like(sys.diag)
    diag = torch.where(sys.fluid, sys.diag, zero)
    hier = build_hierarchy(diag, links, cfg)

    def apply_M(r):
        (r,) = r
        x = v_cycle(hier, torch.where(sys.fluid, r, zero),
                    cfg.mg_pre_smooth, cfg.mg_post_smooth,
                    cfg.mg_omega, cfg.mg_coarse_scale)
        return (torch.where(sys.fluid, x, zero),)

    return apply_M
