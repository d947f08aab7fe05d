"""The Galerkin-aggregation V-cycle over the i-axis slab decomposition.

Counterpart of flipviscosity3d_tpu/parallel/slab_mg.py: the single-device
hierarchy of solvers/multigrid.py, distributed.

- Every level stores its OWNED rows (B_l, J_l, K_l) (+ leading batch axes);
  a stencil apply fetches one ghost row per side from the neighbours.
- Coarsening is multigrid._coarsen on the owned rows: with B_l even, local
  index parity is global parity, so the closed-form Galerkin pooling (the
  links across slab boundaries included) is the single-device P^T A P.
- Once a level has an odd or single owned row, or the global grid is
  coarse enough, the rest of the problem is all-gathered and the
  single-device hierarchy finishes it on every rank alike, built with
  mg_backend "xla" as the JAX package builds it: f32 level operators,
  which the V-cycle kernels K3 / K4 run above the tail's coarsest level.
  At power-of-two grids the gather comes at the coarsest level itself
  (8^3 for pressure, 5^3 for the viscosity blocks; the dense inverse), so
  the tail launches no K3 / K4 there.

The single-device viscosity hierarchy pads its blocks to (I+1, J+1, K+1):
one more i-row than the slabs hold, empty at every level. The viscosity
slab hierarchy counts that row where the single-device one does (its stop
rule, and an empty row appended to the gathered tail), so both build the
same levels and the preconditioner applies the same linear operator as the
single-device v_cycle (up to the order of float sums): the slab CG takes
the single-device iteration counts. The JAX module leaves the row out; its
viscosity hierarchy then stops one level earlier at 32^3 and 128^3, and its
viscosity counts differ from its single-device ones (its test allows a
quarter).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.pallas_mg import pool_sum, prolong
from ..solvers import multigrid as mg
from .collectives import ring

__all__ = [
    "build_slab_hierarchy", "slab_v_cycle",
    "slab_pressure_mg_preconditioner", "slab_viscosity_mg_preconditioner",
]


def _haloed(x, group):
    """x with one ghost row per side on axis -3 from the neighbours; the
    domain's boundary ranks get zeros (the zero fill of multigrid._shift)."""
    n = group.size
    lo, hi = x[..., :1, :, :], x[..., -1:, :, :]
    left, right = group.ppermute_many([(hi, ring(n, +1)),
                                       (lo, ring(n, -1))])
    return torch.cat([left, x, right], dim=-3)


@dataclasses.dataclass
class SlabHierarchy:
    levels: tuple       # distributed MGLevels (owned rows)
    links_g: tuple      # per level: its i-links with ghost rows (B_l+2, ...)
    tail: mg.MGHierarchy   # replicated, from the gathered coarse level
    tail_rows: int      # owned rows at the gather point
    extra_rows: int     # empty i-rows appended to the gathered tail


def _apply_slab(level: mg.MGLevel, link_i_g, x, group):
    """y = A x on the owned rows, ghost rows from the neighbours on the i
    axis; the j / k terms are local shifts."""
    xg = _haloed(x, group)
    y = level.diag * x
    # i axis: row b couples to b+1 through L[b], to b-1 through L[b-1]
    y = y - level.links[0] * xg[..., 2:, :, :] \
        - link_i_g[..., :-2, :, :] * xg[..., :-2, :, :]
    for ax in (1, 2):
        L = level.links[ax]
        y = y - L * mg._shift(x, mg._off(ax, +1))
        y = y - mg._shift(L * x, mg._off(ax, -1))
    return y


def _smooth_slab(level, link_i_g, x, b, iters, omega, group):
    for _ in range(iters):
        r = b - _apply_slab(level, link_i_g, x, group)
        x = x + omega * level.inv_diag * r
    return x


def _gather_rows(x, group, extra_rows: int = 0):
    """(..., B_l, J, K) owned rows -> the global (..., n*B_l, J, K) on every
    rank, and `extra_rows` zero rows after them."""
    return _pad_rows(group.all_gather(x, x.ndim - 3), 0, extra_rows)


def build_slab_hierarchy(diag, links, cfg, group,
                         extra_rows: int = 0) -> SlabHierarchy:
    """diag / links: OWNED rows (B, J, K) (+ leading batch axes); links[0]
    at the last owned row is the link to the right neighbour's first.
    `extra_rows` empty i-rows follow the last slab in the single-device
    operator this one stands for (module docstring)."""
    n = group.size
    levels = [mg._level(diag, links)]
    while True:
        cur = levels[-1]
        b_l = cur.diag.shape[-3]
        gmin = min(b_l * n + extra_rows, cur.diag.shape[-2],
                   cur.diag.shape[-1])
        # an odd B_l would put an aggregate astride a slab boundary (and
        # break the local == global parity) -> gather instead
        if b_l < 2 or b_l % 2 or gmin <= cfg.mg_coarse_size:
            break
        if len(levels) >= cfg.mg_max_levels:
            break
        levels.append(mg._coarsen(cur))
    links_g = tuple(_haloed(lv.links[0], group) for lv in levels)
    coarse = levels[-1]
    tail = mg.build_hierarchy(
        _gather_rows(coarse.diag, group, extra_rows),
        tuple(_gather_rows(L, group, extra_rows) for L in coarse.links),
        dataclasses.replace(cfg, mg_backend="xla"))
    return SlabHierarchy(tuple(levels), links_g, tail,
                         coarse.diag.shape[-3], extra_rows)


def slab_v_cycle(hier: SlabHierarchy, b, cfg, group):
    """One V(pre, post) cycle from x = 0 over the slabs: the operator of the
    single-device v_cycle."""
    pre, post = cfg.mg_pre_smooth, cfg.mg_post_smooth
    omega, scale = cfg.mg_omega, cfg.mg_coarse_scale
    levels = hier.levels

    def tail_solve(b_own):
        x_gl = mg.v_cycle(hier.tail,
                          _gather_rows(b_own, group, hier.extra_rows), pre,
                          post, omega, scale)
        start = group.rank * hier.tail_rows
        return x_gl[..., start:start + hier.tail_rows, :, :]

    def cycle(lvl, b):
        if lvl == len(levels) - 1:
            return tail_solve(b)
        level, link_i_g = levels[lvl], hier.links_g[lvl]
        x = _smooth_slab(level, link_i_g, torch.zeros_like(b), b, pre, omega,
                         group)
        r = b - _apply_slab(level, link_i_g, x, group)
        xc = cycle(lvl + 1, pool_sum(r))
        x = x + scale * prolong(xc, b.shape[-3:])
        return _smooth_slab(level, link_i_g, x, b, post, omega, group)

    return cycle(0, b)


# ---------------------------------------------------------------------------
# the preconditioners of the slab pipeline's two solves
# ---------------------------------------------------------------------------

def _own(x, h):
    return x[..., h:x.shape[-3] - h, :, :]


def _pad_rows(x, before, after):
    """x with zero rows before and after it on axis -3."""
    return F.pad(x, (0, 0, 0, 0, before, after))


def slab_pressure_mg_preconditioner(psys, spec, cfg, group):
    """Slab form of multigrid.pressure_mg_preconditioner: link grids from
    the slab's plus_i/j/k and fluid mask (the interface i-link reads the
    neighbour's fluid flag from the halo), cut to the owned rows."""
    h = spec.H
    zero = torch.zeros_like(psys.diag)
    fluid_f = psys.fluid.to(psys.diag.dtype)
    links = tuple(
        _own((-plus) * fluid_f * mg._shift(fluid_f, mg._off(ax, +1)), h)
        for ax, plus in zip((0, 1, 2), (psys.plus_i, psys.plus_j,
                                        psys.plus_k)))
    diag = _own(torch.where(psys.fluid, psys.diag, zero), h)
    hier = build_slab_hierarchy(diag, links, cfg, group)

    def apply_M(r):
        (r,) = r
        x = slab_v_cycle(hier, _own(torch.where(psys.fluid, r, zero), h),
                         cfg, group)
        return (torch.where(psys.fluid, _pad_rows(x, h, h), zero),)

    return apply_M


def slab_viscosity_mg_preconditioner(vsys, spec, cfg, group):
    """Slab form of multigrid.viscosity_mg_preconditioner: each component's
    7-point block, padded to a common (j, k) extent and stacked on a batch
    axis (one distributed hierarchy for the three)."""
    h = spec.H
    common_jk = (max(g.shape[-2] for g in vsys.diag),
                 max(g.shape[-1] for g in vsys.diag))

    def pad_jk(a):
        return F.pad(a, (0, common_jk[1] - a.shape[-1],
                         0, common_jk[0] - a.shape[-2]))

    diags, links3 = [], []
    for c in range(3):
        links = mg.component_links(vsys.factors[c], vsys.in_mat[c])
        diags.append(pad_jk(_own(vsys.diag[c], h)))
        links3.append(tuple(pad_jk(_own(L, h)) for L in links))
    # the single-device blocks are padded to I + 1 rows (module docstring)
    hier = build_slab_hierarchy(
        torch.stack(diags),
        tuple(torch.stack([links3[c][ax] for c in range(3)])
              for ax in (0, 1, 2)), cfg, group, extra_rows=1)

    def apply_M(r):
        rb = torch.stack([
            pad_jk(_own(torch.where(m, ri, torch.zeros_like(ri)), h))
            for ri, m in zip(r, vsys.in_mat)])
        xb = slab_v_cycle(hier, rb, cfg, group)
        outs = []
        for c, m in enumerate(vsys.in_mat):
            x = _pad_rows(xb[c][:, :m.shape[-2], :m.shape[-1]], h, h)
            outs.append(torch.where(m, x, torch.zeros_like(x)))
        return tuple(outs)

    return apply_M
