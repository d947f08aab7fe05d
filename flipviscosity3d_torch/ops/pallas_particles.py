"""The particle engine of the port: tile-major keys, the pass-A sort, the
visit plans' coverage, the P2G scatter (K1, and K5 over an unsorted stream),
the trilinear MAC gather (K2) and the node-SDF corner gather (K6).

Counterpart of flipviscosity3d_tpu/ops/pallas_particles.py. That module
builds one-hot MXU matmuls over visit plans; the port keeps only what they
compute:

- particles are sorted by a TILE-MAJOR home-cell key (cells grouped into
  8x8x8 tiles, key = tile_id * 512 + local_id), so each cell's particles are
  one contiguous run of the stream, and each particle's rank in its cell is
  its distance from the run start;
- `scatter_p2g_table` gives, per home cell, the 54 Wyvill weights and 54
  weight*velocity sums over the 2x3x3 face window of each MAC component
  (lane comp*18 + oidx, momentum at +54), and the liquid-SDF slot table
  (slot r < cap holds (px, py, pz, 1) of the particle of rank r);
- `gather_mac` samples n_grids in {1, 2} MAC velocity grids trilinearly at
  each particle, restricted to the home cell's 2x3x3 window.

Without a sort (the "stale" pass A, the pass-B midpoint plan, the kernel
pushback) the stream is cut into chunks of C = 512 particles, and a visit
plan lets each chunk touch at most `budget` distinct tiles (and the whole
plan at most midpoint_plan_size visits). Of a plan the port keeps what the
H100 needs: the per-particle `covered` mask, bit for bit the JAX one, and
for the scatter the tile-major incidence list as a CSR (per tile, the
ascending ids of the chunks that touch it). `scatter_p2g_table_stale` then
computes the in-cell ranks itself, in stream order, and `gather_rows8`
reads the 8 node-SDF corners of each covered particle's home cell.

At >= 2^24 cells (256^3) both scatters write their sums K-folded, as the
JAX package does: (I, J, K*SUML) with cell (i, j, k)'s lane f at
k*SUML + f and lanes 108..111 of each cell zero; `p2g_combine` then works
through the sums in i-slabs.

The tile-major column tools are the JAX package's own oracle of the fused
gather, and what its hardware checks drive (scripts/): `build_mac_columns`
stacks the 2x3x3 window of each MAC grid into an F-major tile image
(n_tiles, F, W), `gather_rows` (K7) reads each particle's row of it,
`combine_mac_samples` does the trilinear combine in plain torch, and
`detile` (K8) copies a W-major tile image (n_tiles, W, F) back to
(I, J, K, F). `step` does not take that route: it gathers fused.

The scatters and the MAC gather take the JAX package's pallas_split_terms
as `terms`: at 1 and 2 they round their values as its split one-hot
products do (split_terms, split_round; config.py).

Every kernel wrapper takes the plain PyTorch version for CPU tensors and
launches its CUDA kernel (csrc/*.cu) for CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from .buckets import run_ranks
from .grids import shifted_read
from .stream_transfers import NODE_CORNERS

TILE = (8, 8, 8)
W = TILE[0] * TILE[1] * TILE[2]    # cells per tile
C = 512                             # particles per chunk of a visit plan
N_P2G = 108                         # 54 weight lanes + 54 weight*velocity
SUML = 112                          # lanes per cell of the K-folded sums
FOLD_CELLS = 1 << 24                # cells from which the sums are folded
FAR = 1.0e8                         # empty-slot position sentinel
MAX_CAP = 32                        # slot table capacity the kernels hold
_IMAX = torch.iinfo(torch.int32).max   # pad key / empty extraction slot


def check_grid(grid_shape) -> None:
    if any(s % t for s, t in zip(grid_shape, TILE)):
        raise ValueError(
            f"the particle engine needs grid dims divisible by {TILE}; "
            f"got {tuple(grid_shape)}")


def large_grid(grid_shape) -> bool:
    """The JAX package's auto rule for the large-scene forms (K-folded
    sums, slabbed combine, split gather): at least 2^24 cells."""
    return grid_shape[0] * grid_shape[1] * grid_shape[2] >= FOLD_CELLS


def tile_counts(grid_shape):
    return tuple(s // t for s, t in zip(grid_shape, TILE))


def tile_major_key(i, j, k, grid_shape):
    """Clamped int32 cell coords -> tile-major flat key."""
    nt = tile_counts(grid_shape)
    tile = ((i // TILE[0]) * nt[1] + (j // TILE[1])) * nt[2] + (k // TILE[2])
    local = ((i % TILE[0]) * TILE[1] + (j % TILE[1])) * TILE[2] + (
        k % TILE[2])
    return tile * W + local


def key_of_position(pos, dx, grid_shape):
    """Tile-major home-cell key of (N,3) positions: floor(p/dx) clamped into
    the grid (grid3d.h:37-43)."""
    idx = torch.floor(pos / dx).to(torch.int32)
    ijk = [idx[:, a].clamp(0, grid_shape[a] - 1) for a in range(3)]
    return tile_major_key(*ijk, grid_shape).to(torch.int32)


def decode_key(keys, grid_shape):
    """Tile-major key -> (i, j, k) int32 cell coords."""
    nt = tile_counts(grid_shape)
    tile = keys // W
    local = keys % W
    ti = tile // (nt[1] * nt[2])
    tj = (tile // nt[2]) % nt[1]
    tk = tile % nt[2]
    li = local // (TILE[1] * TILE[2])
    lj = (local // TILE[2]) % TILE[1]
    lk = local % TILE[2]
    return ti * TILE[0] + li, tj * TILE[1] + lj, tk * TILE[2] + lk


@dataclasses.dataclass
class TiledStream:
    """Pass-A particles, stably sorted by tile-major home-cell key."""

    key: torch.Tensor    # (N,) int32 sorted keys
    rank: torch.Tensor   # (N,) int32 rank within the cell's run
    pos: torch.Tensor    # (N,3) sorted positions
    vel: torch.Tensor    # (N,3) sorted velocities


def tiled_sort(pos, vel, dx, grid_shape) -> TiledStream:
    """One stable sort per substep plus the in-cell rank by run starts."""
    key = key_of_position(pos, dx, grid_shape)
    key_s, perm = torch.sort(key, stable=True)
    return TiledStream(key_s, run_ranks(key_s, torch.int32), pos[perm],
                       vel[perm])


def sort_by_key(key, fields):
    """Stable sort of `fields` (tensors of leading size N) by `key` ->
    (sorted key, tuple of sorted fields): the pass-B "sort" re-sort and the
    stale pass A's periodic re-sort."""
    key_s, perm = torch.sort(key, stable=True)
    return key_s, tuple(f[perm] for f in fields)


# ---------------------------------------------------------------------------
# visit-plan coverage without a sort
# ---------------------------------------------------------------------------

def n_chunks(n: int) -> int:
    return (n + C - 1) // C


def midpoint_plan_size(n: int, factor: float = 3.0, budget: int = 8) -> int:
    """Visit capacity of a budget plan over n particles: budget visits per
    chunk outright while that is <= 8192 visits (exhaustive within the
    budget), else factor visits per chunk (at least one more than a chunk
    each, plus 8). Incidences past the capacity are not covered."""
    exhaustive = budget * n_chunks(n)
    if exhaustive <= 8192:
        return exhaustive
    return max(int(factor * n_chunks(n)), n_chunks(n) + 8)


def _pad_chunk_keys(key):
    """(N,) keys -> (n_chunks, C) int32, the ragged last chunk padded with
    _IMAX."""
    n = key.shape[0]
    km = key.to(torch.int32)
    pad = n_chunks(n) * C - n
    if pad:
        km = torch.cat([km, torch.full((pad,), _IMAX, dtype=torch.int32,
                                       device=km.device)])
    return km.reshape(-1, C)


def _budget_extract(kmr, budget: int):
    """Per-chunk distinct tiles, ascending, by `budget` min-sweeps. Returns
    (tiles (n_chunks, budget) with _IMAX empties, tm (n_chunks, C) each
    particle's tile, off (n_chunks + 1,) the chunks' first visit)."""
    tm = torch.where(kmr == _IMAX, kmr, kmr // W)
    rem = tm
    tiles = []
    for _ in range(budget):
        m = rem.min(dim=1).values
        tiles.append(m)
        rem = rem.masked_fill(rem == m[:, None], _IMAX)
    tiles = torch.stack(tiles, dim=1)
    cnt = (tiles != _IMAX).sum(dim=1, dtype=torch.int32)
    off = torch.cat([torch.zeros(1, dtype=torch.int32, device=kmr.device),
                     torch.cumsum(cnt, 0, dtype=torch.int32)])
    return tiles, tm, off


def _budget_plan(key, budget: int, factor: float):
    """One budget extraction over keys in stream order -> (covered (N,)
    bool, tiles, off, nv). A particle is covered iff its tile was extracted
    for its chunk and that incidence's visit (the chunk's first visit plus
    the tile's rank among the chunk's tiles) lies inside the plan's nv
    visits; off[-1] is the number of visits the chunks ask for."""
    n = key.shape[0]
    kmr = _pad_chunk_keys(key)
    tiles, tm, off = _budget_extract(kmr, budget)
    nv = midpoint_plan_size(n, factor, budget)
    slot = torch.zeros_like(tm)
    hit = torch.zeros(tm.shape, dtype=torch.bool, device=tm.device)
    for bb in range(budget):
        col = tiles[:, bb:bb + 1]
        slot += (col < tm).to(torch.int32)
        hit |= col == tm
    placed = off[:-1, None] + slot < nv
    covered = hit & (slot < budget) & placed & (kmr != _IMAX)
    return covered.reshape(-1)[:n], tiles, off, nv


@dataclasses.dataclass
class VisitPlan:
    """What the H100 keeps of a visit plan over keys in stream order.

    covered: (N,) bool. False marks a particle the plan does not visit:
        the caller falls back and counts it.
    visits: () int32 on the keys' device, the visits the chunks ask for
        before the capacity cut (the distinct tiles of each chunk, at most
        budget per chunk); coverage is cut once it exceeds
        midpoint_plan_size.
    """

    covered: torch.Tensor
    visits: torch.Tensor


def plan_midpoint_visits(key_m, budget: int = 8,
                         factor: float = 3.0) -> VisitPlan:
    """The midpoint visit plan over keys in their current (pass-A)
    order."""
    covered, _, off, _ = _budget_plan(key_m, budget, factor)
    return VisitPlan(covered, off[-1])


@dataclasses.dataclass
class ScatterPlan(VisitPlan):
    """The stale pass A's plan over unsorted home keys: a VisitPlan (its
    coverage equal to plan_midpoint_visits over the same keys) and

    tile_ptr: (n_tiles + 1,) int32 and tile_chunks: (n_incidences,) int32,
        a CSR: the chunks touching tile t are tile_chunks[tile_ptr[t]:
        tile_ptr[t + 1]], ascending. A listed (chunk, tile) pair covers
        every particle of the chunk homed in the tile.
    """

    tile_ptr: torch.Tensor
    tile_chunks: torch.Tensor


def plan_pass_a(key, grid_shape, budget: int = 8,
                factor: float = 3.0) -> ScatterPlan:
    """Both pass-A plans from one budget extraction: the coverage (which
    also decides the G2P gather's rows) and the scatter's tile-major
    incidence CSR."""
    n_tiles = (grid_shape[0] * grid_shape[1] * grid_shape[2]) // W
    covered, tiles, off, nv = _budget_plan(key, budget, factor)
    b = torch.arange(budget, dtype=torch.int32, device=key.device)
    placed = (tiles != _IMAX) & (off[:-1, None] + b < nv)
    chunk = torch.arange(tiles.shape[0], dtype=torch.int32,
                         device=key.device)[:, None].expand_as(tiles)
    # chunk-major incidences, re-sorted tile-major; the stable sort keeps
    # each tile's chunks ascending
    tv, order = torch.sort(tiles[placed], stable=True)
    per_tile = torch.bincount(tv.long(), minlength=n_tiles)
    tile_ptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                      device=key.device),
                          torch.cumsum(per_tile, 0)]).to(torch.int32)
    return ScatterPlan(covered, off[-1], tile_ptr,
                       chunk[placed][order].contiguous())


def p2g_abs_offset(comp: int, oidx: int):
    """Absolute (x,y,z) face offset of window lane oidx of component comp:
    ox in {0,1} on the component axis, oy/oz in {-1,0,1} across it."""
    ox, oy, oz = oidx // 9, (oidx // 3) % 3 - 1, oidx % 3 - 1
    if comp == 0:
        return (ox, oy, oz)
    if comp == 1:
        return (oy, ox, oz)
    return (oy, oz, ox)


def _f32(x) -> float:
    return float(np.float32(x))


def wyvill_constants(dx):
    """(c1, c2, c3, r2) of the Wyvill kernel (fluidsimulation.cpp:385-413),
    rounded to f32 once, as the JAX kernel rounds them."""
    return (_f32((4.0 / 9.0) / dx**6), _f32((17.0 / 9.0) / dx**4),
            _f32((22.0 / 9.0) / dx**2), _f32(dx * dx))


def split_terms(x, terms: int):
    """The bf16 terms of the JAX package's split products
    (flipviscosity3d_tpu/ops/pallas_particles.py::_split3) at `terms` 1 or
    2, widened to f32: (bf16(x),) or (bf16(x), bf16(x - bf16(x))), rounded
    to nearest even. Any other `terms` is the exact product: (x,)."""
    if terms not in (1, 2):
        return (x,)
    t1 = x.to(torch.bfloat16).float()
    if terms == 1:
        return (t1,)
    return t1, (x - t1).to(torch.bfloat16).float()


def split_round(x, terms: int):
    """x as a split product with a 0/1 one-hot sees it: the sum of its
    split_terms (exact in f32)."""
    parts = split_terms(x, terms)
    return parts[0] if len(parts) == 1 else parts[0] + parts[1]


# ---------------------------------------------------------------------------
# K1: P2G sums + liquid-SDF slot table
# ---------------------------------------------------------------------------

def _fold(sums4):
    """(I,J,K,108) sums -> the K-folded (I, J, K*SUML) form, pads zero."""
    ni, nj, nk, _ = sums4.shape
    padded = torch.nn.functional.pad(sums4, (0, SUML - N_P2G))
    return padded.reshape(ni, nj, nk * SUML)


def scatter_p2g_table_ref(pos_s, vel_s, key_s, rank, grid_shape, dx, cap,
                          fold_sums=None, slabs: int = 1, terms: int = 3):
    """Plain version of scatter_p2g_table (index_add over cells). `slabs`
    cuts the stream into that many runs of particles, added one after the
    other into the same sums and table, so that the (N, 108) values need not
    exist at once: the same result for a large stream in less memory. At
    `terms` 1 or 2 each of the 108 values is cut into its split_terms, each
    term summed over a cell by itself and the sums added at the end, and the
    table holds split_round of the positions."""
    if fold_sums is None:
        fold_sums = large_grid(grid_shape)
    dev = pos_s.device
    n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]
    lanes = [p2g_abs_offset(l // 18, l % 18) for l in range(54)]
    comp = torch.tensor([l // 18 for l in range(54)], device=dev)
    a = torch.tensor(lanes, dtype=torch.float32, device=dev)      # (54, 3)
    s = torch.tensor([[0.0 if c == ax else 0.5 for ax in range(3)]
                      for c in (l // 18 for l in range(54))],
                     dtype=torch.float32, device=dev)
    c1, c2, c3, r2 = wyvill_constants(dx)
    sums = [torch.zeros((n_cells, N_P2G), dtype=torch.float32, device=dev)
            for _ in range(2 if terms == 2 else 1)]
    table = torch.zeros((n_cells * cap, 4), dtype=torch.float32, device=dev)
    per_slab = -(-max(pos_s.shape[0], 1) // slabs)
    for pos, vel, key, rk in zip(*(t.split(per_slab)
                                   for t in (pos_s, vel_s, key_s, rank))):
        gi, gj, gk = decode_key(key.long(), grid_shape)
        g = [c.to(torch.float32)[:, None] for c in (gi, gj, gk)]
        f = [(g[ax] + a[:, ax]) * dx - (pos[:, ax:ax + 1] - s[:, ax] * dx)
             for ax in range(3)]
        d2 = f[0] * f[0] + f[1] * f[1] + f[2] * f[2]
        wgt = 1.0 - c1 * d2 * d2 * d2 + c2 * d2 * d2 - c3 * d2
        wgt = torch.where(d2 < r2, wgt, torch.zeros_like(wgt))
        std = (gi * grid_shape[1] + gj) * grid_shape[2] + gk
        vals = torch.cat([wgt, wgt * vel[:, comp]], dim=1)
        for acc, part in zip(sums, split_terms(vals, terms)):
            acc.index_add_(0, std, part)
        keep = rk < cap
        table[std[keep] * cap + rk[keep].long()] = torch.cat(
            [split_round(pos, terms), torch.ones_like(pos[:, :1])],
            dim=1)[keep]
    sums = (sums[0] if len(sums) == 1 else sums[0] + sums[1]).reshape(
        *grid_shape, N_P2G)
    return (_fold(sums) if fold_sums else sums,
            table.reshape(*grid_shape, cap, 4))


_P, _I, _F = _build.P, _build.I, _build.F
_SCATTER_ARGS = (_P,) * 4 + (_I,) * 5 + (_F,) * 5 + (_I,) * 2 + (_P,) * 2 + (
    _P,)


def _kernel_terms(terms: int) -> int:
    """The kernels' terms argument: 1 or 2, or 3 for the exact product."""
    return terms if terms in (1, 2) else 3


def _empty_sums(grid_shape, fold_sums, device):
    """The scatter kernels' sums output, not initialised: (I,J,K,108), or
    K-folded (I, J, K*SUML) -> (tensor, floats per cell row)."""
    ni, nj, nk = grid_shape
    shape = (ni, nj, nk * SUML) if fold_sums else (ni, nj, nk, N_P2G)
    return (torch.empty(shape, dtype=torch.float32, device=device),
            SUML if fold_sums else N_P2G)


def scatter_p2g_table(pos_s, vel_s, key_s, rank, grid_shape, dx, cap,
                      fold_sums=None, terms: int = 3):
    """Per-cell P2G sums and liquid-SDF slot table of a tile-key-sorted
    stream -> (sums f32, table (I,J,K,cap,4) f32). `rank` holds each
    particle's rank in its cell: its cell's particles have the ranks 0 ..
    count - 1 (tiled_sort's run ranks). Particles of rank >= cap are left
    out of the table only. Each cell's particles are summed in stream
    order. sums is (I,J,K,108), or, with fold_sums (None: at >= 2^24
    cells), K-folded (I, J, K*SUML): the same kernel with a row stride of
    SUML floats and the pad lanes written as zero, counted as
    scatter_p2g_table_folded. `terms` 1 or 2 rounds the values as the JAX
    package's split products do (split_terms; config.py)."""
    check_grid(grid_shape)
    if fold_sums is None:
        fold_sums = large_grid(grid_shape)
    if _build.on_cpu(pos_s, "scatter_p2g_table"):
        return scatter_p2g_table_ref(pos_s, vel_s, key_s, rank, grid_shape,
                                     dx, cap, fold_sums, terms=terms)
    n = pos_s.shape[0]
    _build.require(pos_s, "pos_s", torch.float32, (n, 3))
    _build.require(vel_s, "vel_s", torch.float32, (n, 3))
    _build.require(key_s, "key_s", torch.int32, (n,))
    _build.require(rank, "rank", torch.int32, (n,))
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"scatter_p2g_table: cap must be in [1, {MAX_CAP}]")
    ni, nj, nk = grid_shape
    sums, stride = _empty_sums(grid_shape, fold_sums, pos_s.device)
    table = torch.empty((ni, nj, nk, cap, 4), dtype=torch.float32,
                        device=pos_s.device)
    c1, c2, c3, r2 = wyvill_constants(dx)
    _build.launch(
        "flip3d_p2g_scatter", _SCATTER_ARGS,
        pos_s.data_ptr(), vel_s.data_ptr(), key_s.data_ptr(),
        rank.data_ptr(), n, ni, nj, nk, cap, _f32(dx), c1, c2, c3, r2,
        stride, _kernel_terms(terms), sums.data_ptr(), table.data_ptr())
    _build.count(scatter_p2g_table_folded if fold_sums
                 else scatter_p2g_table)
    return sums, table


def scatter_p2g_table_folded(pos_s, vel_s, key_s, rank, grid_shape, dx, cap,
                             terms: int = 3):
    """scatter_p2g_table with the fold forced, at any grid size; its
    `launches` counts every folded launch of that kernel."""
    return scatter_p2g_table(pos_s, vel_s, key_s, rank, grid_shape, dx, cap,
                             fold_sums=True, terms=terms)


scatter_p2g_table.launches = 0
scatter_p2g_table_folded.launches = 0


# ---------------------------------------------------------------------------
# K5: the same sums and table over an unsorted stream, ranks in the kernel
# ---------------------------------------------------------------------------

def table_rank_overflow(counts, cap):
    """Covered particles left out of the SDF table: sum over cells of
    max(count - cap, 0), from the scatter's per-cell counts."""
    return torch.clamp(counts - cap, min=0).sum()


def stale_ranks(key, covered):
    """The rank of each covered particle in stream order among the covered
    particles of its cell, for key[covered] (int32): by a stable sort of
    their keys."""
    key_s, perm = torch.sort(key[covered], stable=True)
    rank = torch.empty_like(key_s, dtype=torch.int32)
    rank[perm] = run_ranks(key_s, torch.int32)
    return rank


def stale_order_ref(key, plan: ScatterPlan, grid_shape):
    """Plain version of the order half of scatter_p2g_table_stale's kernel:
    the particles that take part (covered, their chunk listed for their
    tile by the plan's CSR) in the order of a sorted stream, by (key, stream
    position) -> (order (m,) int64 stream indices, tile_off (n_tiles + 1,)
    int64 the start of each tile's run in order). Particle order[p]'s rank
    in its cell is p less the first p of its key."""
    n = key.shape[0]
    n_tiles = (grid_shape[0] * grid_shape[1] * grid_shape[2]) // W
    dev = key.device
    per_tile = plan.tile_ptr[1:].long() - plan.tile_ptr[:-1].long()
    listed = (plan.tile_chunks.long() * n_tiles + torch.repeat_interleave(
        torch.arange(n_tiles, device=dev), per_tile))
    q = torch.arange(n, device=dev)
    mine = (q // C) * n_tiles + key.long() // W
    part = torch.nonzero(plan.covered & torch.isin(mine, listed))[:, 0]
    _, perm = torch.sort(key[part], stable=True)
    order = part[perm]
    counts = torch.bincount(key[order].long() // W, minlength=n_tiles)
    tile_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(counts, 0)])
    return order, tile_off


def scatter_p2g_table_stale_ref(pos, vel, key, covered, grid_shape, dx,
                                cap, fold_sums=None, slabs: int = 1,
                                terms: int = 3):
    """Plain version of scatter_p2g_table_stale: the covered particles' ranks
    (stale_ranks), then scatter_p2g_table_ref (in `slabs` runs of particles,
    at `terms`)."""
    key_c = key[covered]
    rank = stale_ranks(key, covered)
    sums, table = scatter_p2g_table_ref(pos[covered], vel[covered], key_c,
                                        rank, grid_shape, dx, cap, fold_sums,
                                        slabs, terms)
    gi, gj, gk = decode_key(key_c.long(), grid_shape)
    std = (gi * grid_shape[1] + gj) * grid_shape[2] + gk
    counts = torch.bincount(std, minlength=grid_shape[0] * grid_shape[1]
                            * grid_shape[2])
    return sums, table, counts.to(torch.int32).reshape(grid_shape)


_STALE_ARGS = (_P,) * 4 + (_I,) + (_P,) * 2 + (_I,) * 4 + (_F,) * 5 + (
    _I,) * 2 + (_P,) * 5 + (_P,)


def scatter_p2g_table_stale(pos, vel, key, plan: ScatterPlan, grid_shape, dx,
                            cap, fold_sums=None, terms: int = 3):
    """scatter_p2g_table over a stream in any order, restricted to the
    plan's covered particles -> (sums f32 as scatter_p2g_table's, folded
    under the same rule, table (I,J,K,cap,4) f32, counts (I,J,K) int32). A
    particle's rank is its position in stream order among the covered
    particles of its cell; counts holds every covered particle of the cell,
    ranks >= cap included. The inputs are the stream as it is (the TPU's
    stale_payload rows have no counterpart: the kernel decodes the keys
    itself). Folded launches count as scatter_p2g_table_stale_folded, and
    a launch counts once, although the kernel runs in two halves (an order
    of the covered particles, stale_order_ref's, then K1's walk over it),
    with one int32 a particle and n_tiles + 1 of scratch. `terms` rounds as
    scatter_p2g_table's does."""
    check_grid(grid_shape)
    if fold_sums is None:
        fold_sums = large_grid(grid_shape)
    if _build.on_cpu(pos, "scatter_p2g_table_stale"):
        return scatter_p2g_table_stale_ref(pos, vel, key, plan.covered,
                                           grid_shape, dx, cap, fold_sums,
                                           terms=terms)
    n = pos.shape[0]
    ni, nj, nk = grid_shape
    n_tiles = (ni * nj * nk) // W
    _build.require(pos, "pos", torch.float32, (n, 3))
    _build.require(vel, "vel", torch.float32, (n, 3))
    _build.require(key, "key", torch.int32, (n,))
    _build.require(plan.covered, "covered", torch.bool, (n,))
    _build.require(plan.tile_ptr, "tile_ptr", torch.int32, (n_tiles + 1,))
    _build.require(plan.tile_chunks, "tile_chunks", torch.int32)
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(
            f"scatter_p2g_table_stale: cap must be in [1, {MAX_CAP}]")
    dev = pos.device
    sums, stride = _empty_sums(grid_shape, fold_sums, dev)
    table = torch.empty((ni, nj, nk, cap, 4), dtype=torch.float32,
                        device=dev)
    counts = torch.empty((ni, nj, nk), dtype=torch.int32, device=dev)
    order = torch.empty((n,), dtype=torch.int32, device=dev)
    tile_off = torch.empty((n_tiles + 1,), dtype=torch.int32, device=dev)
    c1, c2, c3, r2 = wyvill_constants(dx)
    _build.launch(
        "flip3d_p2g_scatter_stale", _STALE_ARGS,
        pos.data_ptr(), vel.data_ptr(), key.data_ptr(),
        plan.covered.data_ptr(), n, plan.tile_ptr.data_ptr(),
        plan.tile_chunks.data_ptr(), ni, nj, nk, cap, _f32(dx), c1, c2, c3,
        r2, stride, _kernel_terms(terms), sums.data_ptr(), table.data_ptr(),
        counts.data_ptr(), order.data_ptr(), tile_off.data_ptr())
    _build.count(scatter_p2g_table_stale_folded if fold_sums
                 else scatter_p2g_table_stale)
    return sums, table, counts


def scatter_p2g_table_stale_folded(pos, vel, key, plan: ScatterPlan,
                                   grid_shape, dx, cap, terms: int = 3):
    """scatter_p2g_table_stale with the fold forced, at any grid size; its
    `launches` counts every folded launch of that kernel."""
    return scatter_p2g_table_stale(pos, vel, key, plan, grid_shape, dx, cap,
                                   fold_sums=True, terms=terms)


scatter_p2g_table_stale.launches = 0
scatter_p2g_table_stale_folded.launches = 0


def table_fields(table, cap):
    """(I,J,K,cap,4) slot table -> (px, py, pz), each (cap, n_cells), with
    FAR in empty slots (the liquid-SDF sweep's slot-major layout)."""
    n_cells = table.shape[0] * table.shape[1] * table.shape[2]
    t = table.reshape(n_cells, cap, 4).permute(1, 0, 2)
    occ = t[..., 3] > 0.5
    far = torch.full_like(t[..., 0], FAR)
    return tuple(torch.where(occ, t[..., f], far) for f in range(3))


def _combine_cells(lanes, face_shapes):
    """The shifted accumulation of p2g_combine on one block of cells;
    `lanes` is lane-leading, (>= 108, i, J, K)."""
    acc = []
    for comp in range(3):
        fs = face_shapes[comp]
        vs = torch.zeros(fs, dtype=torch.float32, device=lanes.device)
        ws = torch.zeros(fs, dtype=torch.float32, device=lanes.device)
        for oidx in range(18):
            neg = tuple(-v for v in p2g_abs_offset(comp, oidx))
            lane = comp * 18 + oidx
            ws = ws + shifted_read(lanes[lane], neg, fs)
            vs = vs + shifted_read(lanes[54 + lane], neg, fs)
        acc.append((vs, ws))
    return acc


def p2g_combine(sums, grid_shape, face_shapes, i_slabs=None):
    """Per-cell P2G sums -> [(val_sum, w_sum)] per component: face
    f = cell + offset receives the cell's lane. `sums` is (I,J,K,108) or
    K-folded (I, J, K*108) or (I, J, K*SUML).

    i_slabs == 1 reads each lane through a strided view of the whole sums.
    i_slabs > 1 (None: 8 at >= 2^24 cells when I % 8 == 0, else 1) is the
    JAX package's slabbed form: per slab of I / i_slabs cell rows, a window
    of two more rows (the offsets reach +-1) is copied lane-leading, combined,
    and the face rows the slab owns are pasted; the u grid's row on a seam
    is complete in both neighbours' windows and pasted twice. Only one
    window's lane-leading copy is alive at a time, and the result is bit
    for bit that of i_slabs == 1."""
    isz, nj, nk = grid_shape
    cells = sums.reshape(isz, nj, nk, -1)
    if i_slabs is None:
        i_slabs = 8 if (large_grid(grid_shape) and isz % 8 == 0) else 1
    if i_slabs == 1:
        return _combine_cells(cells.permute(3, 0, 1, 2), face_shapes)

    bw = isz // i_slabs
    win = bw + 2
    local_fs = ((win + 1,) + tuple(face_shapes[0][1:]),
                (win,) + tuple(face_shapes[1][1:]),
                (win,) + tuple(face_shapes[2][1:]))
    out = [tuple(torch.zeros(fs, dtype=torch.float32, device=sums.device)
                 for _ in range(2)) for fs in face_shapes]
    for s in range(i_slabs):
        i0 = s * bw
        start = min(max(i0 - 1, 0), isz - win)
        off = i0 - start   # 0 on the first slab, 2 on the last, else 1
        lanes = cells[start:start + win, ..., :N_P2G].permute(
            3, 0, 1, 2).contiguous()
        part = _combine_cells(lanes, local_fs)
        for comp in range(3):
            rows = bw + (1 if comp == 0 else 0)
            for dst, src in zip(out[comp], part[comp]):
                dst[i0:i0 + rows] = src[off:off + rows]
    return out


# ---------------------------------------------------------------------------
# K2: trilinear MAC samples in the home cell's window
# ---------------------------------------------------------------------------

_MAC_OFFSETS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))


def gather_mac_ref(px, py, pz, keys, grids_u, grids_v, grids_w, dx,
                   grid_shape, terms: int = 3):
    """Plain version of gather_mac: per component and grid the 18 window
    faces in window order, each weight a product over the axes x, y, z,
    added one by one."""
    home = decode_key(keys.long(), grid_shape)
    ps = (px, py, pz)
    comp_grids = (grids_u, grids_v, grids_w)
    n_grids = len(grids_u)
    out = torch.zeros((3 * n_grids, px.shape[0]), dtype=torch.float32,
                      device=px.device)
    for comp in range(3):
        fr, delta = [], []
        for ax in range(3):
            f = ps[ax] / dx - _MAC_OFFSETS[comp][ax]
            b = torch.floor(f)
            fr.append(f - b)
            delta.append(b.to(torch.int64) - home[ax])
        for g in range(n_grids):
            grid = split_round(comp_grids[comp][g], terms)
            acc = torch.zeros_like(px)
            for oidx in range(18):
                o = p2g_abs_offset(comp, oidx)
                w = None
                idx = []
                ok = torch.ones_like(px, dtype=torch.bool)
                for ax in range(3):
                    corner = o[ax] - delta[ax]
                    wa = torch.where(
                        corner == 0, 1.0 - fr[ax],
                        torch.where(corner == 1, fr[ax],
                                    torch.zeros_like(fr[ax])))
                    w = wa if w is None else w * wa
                    c = home[ax] + o[ax]
                    ok = ok & (c >= 0) & (c < grid.shape[ax])
                    idx.append(c.clamp(0, grid.shape[ax] - 1))
                val = torch.where(ok, grid[idx[0], idx[1], idx[2]],
                                  torch.zeros_like(px))
                acc = acc + w * val
            out[g * 3 + comp] = acc
    return out


_GATHER_ARGS = (_P,) * 4 + (_I,) * 2 + (_P,) * 6 + (_I,) * 3 + (_F,) * 2 + (
    _I,) + (_P,) + (_P,)


def _exact_inverse(dx) -> float:
    """1 / dx where f32(dx) is a power of two (p * (1 / dx) is then p / dx,
    bit for bit), else 0 (the kernel divides)."""
    mantissa, _ = np.frexp(np.float32(dx))
    return _f32(1.0 / _f32(dx)) if mantissa == 0.5 else 0.0


def gather_mac(px, py, pz, keys, grids_u, grids_v, grids_w, dx, grid_shape,
               terms: int = 3):
    """Trilinear MAC samples of n_grids = len(grids_u) in {1, 2} velocity
    grids at each particle -> (3*n_grids, N) f32, rows grid-major
    (g*3 + comp). Only the 2x3x3 window of the particle's (clamped) home cell
    `keys` counts; faces outside a face grid read 0. Keys may come in any
    order. `terms` 1 or 2 rounds each face value as the JAX package's split
    products do (split_round) before it is weighted. Launches of two grids
    count as gather_mac, of one grid as gather_mac_one_grid."""
    check_grid(grid_shape)
    n_grids = len(grids_u)
    if n_grids not in (1, 2) or len(grids_v) != n_grids or \
            len(grids_w) != n_grids:
        raise ValueError("gather_mac: 1 or 2 grids per component")
    if _build.on_cpu(px, "gather_mac"):
        return gather_mac_ref(px, py, pz, keys, grids_u, grids_v, grids_w,
                              dx, grid_shape, terms)
    n = px.shape[0]
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        _build.require(t, name, torch.float32, (n,))
    _build.require(keys, "keys", torch.int32, (n,))
    ni, nj, nk = grid_shape
    face_shapes = ((ni + 1, nj, nk), (ni, nj + 1, nk), (ni, nj, nk + 1))
    ptrs = []
    for g in range(2):
        for comp, grids in enumerate((grids_u, grids_v, grids_w)):
            if g < n_grids:
                _build.require(grids[g], f"grid[{g}][{comp}]",
                               torch.float32, face_shapes[comp])
                ptrs.append(grids[g].data_ptr())
            else:
                ptrs.append(None)
    out = torch.empty((3 * n_grids, n), dtype=torch.float32, device=px.device)
    _build.launch(
        "flip3d_gather_mac", _GATHER_ARGS,
        px.data_ptr(), py.data_ptr(), pz.data_ptr(), keys.data_ptr(),
        n, n_grids, *ptrs, ni, nj, nk, _f32(dx), _exact_inverse(dx),
        _kernel_terms(terms), out.data_ptr())
    _build.count(gather_mac if n_grids == 2 else gather_mac_one_grid)
    return out


def gather_mac_one_grid(px, py, pz, keys, grid_u, grid_v, grid_w, dx,
                        grid_shape, terms: int = 3):
    """gather_mac of one grid per component (pass B's midpoint sample); its
    `launches` counts every one-grid launch of that kernel."""
    return gather_mac(px, py, pz, keys, [grid_u], [grid_v], [grid_w], dx,
                      grid_shape, terms)


gather_mac.launches = 0
gather_mac_one_grid.launches = 0


# ---------------------------------------------------------------------------
# K6: the 8 node-SDF corners of each covered particle's home cell
# ---------------------------------------------------------------------------

def gather_rows8_ref(keys, covered, phi_node, grid_shape):
    """Plain version of gather_rows8."""
    i, j, k = decode_key(keys.long(), grid_shape)
    rows = torch.stack([phi_node[i + a, j + b, k + c]
                        for a, b, c in NODE_CORNERS])
    return torch.where(covered, rows, torch.zeros_like(rows))


_ROWS8_ARGS = (_P,) * 2 + (_I,) + (_P,) + (_I,) * 3 + (_P,) + (_P,)


def gather_rows8(keys, covered, phi_node, grid_shape):
    """Node SDF corners phi_node[cell + o] for o in NODE_CORNERS (the
    pushback's trilinear corners) of each particle's tile-major home cell
    `keys` -> (8, N) f32; rows of uncovered particles are zero."""
    check_grid(grid_shape)
    if _build.on_cpu(keys, "gather_rows8"):
        return gather_rows8_ref(keys, covered, phi_node, grid_shape)
    n = keys.shape[0]
    ni, nj, nk = grid_shape
    _build.require(keys, "keys", torch.int32, (n,))
    _build.require(covered, "covered", torch.bool, (n,))
    _build.require(phi_node, "phi_node", torch.float32,
                   (ni + 1, nj + 1, nk + 1))
    out = torch.empty((8, n), dtype=torch.float32, device=keys.device)
    _build.launch(
        "flip3d_gather_rows8", _ROWS8_ARGS,
        keys.data_ptr(), covered.data_ptr(), n, phi_node.data_ptr(),
        ni, nj, nk, out.data_ptr())
    gather_rows8.launches += 1
    return out


gather_rows8.launches = 0


# ---------------------------------------------------------------------------
# layout conversion: (I, J, K, F) <-> tile-major (n_tiles, W, F); K8
# ---------------------------------------------------------------------------

def to_tile_major(x):
    """(I, J, K, F) -> (n_tiles, W, F)."""
    i, j, k, f = x.shape
    nt = tile_counts((i, j, k))
    x = x.reshape(nt[0], TILE[0], nt[1], TILE[1], nt[2], TILE[2], f)
    return x.permute(0, 2, 4, 1, 3, 5, 6).reshape(nt[0] * nt[1] * nt[2], W, f)


def stack_tile_major(cols, grid_shape):
    """F (I, J, K) column grids -> (n_tiles, W, F) tile-major image."""
    f = len(cols)
    nt = tile_counts(grid_shape)
    x = torch.stack(list(cols), dim=0)
    x = x.reshape(f, nt[0], TILE[0], nt[1], TILE[1], nt[2], TILE[2])
    return x.permute(1, 3, 5, 2, 4, 6, 0).reshape(
        nt[0] * nt[1] * nt[2], W, f)


def stack_tile_major_fw(cols, grid_shape, i_slabs=None, dtype=torch.float32):
    """F (I, J, K) column grids -> (n_tiles, f_pad, W) F-MAJOR tile image of
    `dtype` (f32 or bf16, rounded to nearest even), f_pad the next multiple
    of 8 with the pad lanes zero.

    The image is filled in i_slabs slabs of tile rows (None: 8 at >= 2^24
    cells when the tile rows divide by 8, else 1): per slab the columns'
    rows are stacked lane-leading and relaid into their tiles, so only one
    slab's stack is alive beside the columns and the image. The result is
    the same for every i_slabs."""
    f = len(cols)
    nt = tile_counts(grid_shape)
    f_pad = -(-f // 8) * 8
    if i_slabs is None:
        i_slabs = 8 if (large_grid(grid_shape) and nt[0] % 8 == 0) else 1
    if nt[0] % i_slabs:
        raise ValueError(f"stack_tile_major_fw: {i_slabs} slabs do not divide "
                         f"{nt[0]} tile rows")
    per_t = nt[0] // i_slabs            # tile rows per slab
    rows = per_t * TILE[0]
    tiles_per = per_t * nt[1] * nt[2]
    out = torch.empty((nt[0] * nt[1] * nt[2], f_pad, W), dtype=dtype,
                      device=cols[0].device)
    for s in range(i_slabs):
        x = torch.zeros((f_pad, rows) + tuple(grid_shape[1:]), dtype=dtype,
                        device=out.device)
        for lane, col in enumerate(cols):
            x[lane] = col[s * rows:(s + 1) * rows]
        x = x.reshape(f_pad, per_t, TILE[0], nt[1], TILE[1], nt[2], TILE[2])
        out[s * tiles_per:(s + 1) * tiles_per] = x.permute(
            1, 3, 5, 0, 2, 4, 6).reshape(tiles_per, f_pad, W)
    return out


def from_tile_major(y, grid_shape):
    """(n_tiles, W, F) -> (I, J, K, F): the plain version of detile."""
    f = y.shape[-1]
    nt = tile_counts(grid_shape)
    y = y.reshape(nt[0], nt[1], nt[2], TILE[0], TILE[1], TILE[2], f)
    return y.permute(0, 3, 1, 4, 2, 5, 6).reshape(*grid_shape, f)


_DETILE_ARGS = (_P,) + (_I,) * 4 + (_P,) + (_P,)


def detile(y, grid_shape):
    """(n_tiles, W, F) f32 -> (I, J, K, F), as a copy kernel (K8)."""
    check_grid(grid_shape)
    if _build.on_cpu(y, "detile"):
        return from_tile_major(y, grid_shape)
    ni, nj, nk = grid_shape
    f = y.shape[-1]
    _build.require(y, "y", torch.float32, ((ni * nj * nk) // W, W, f))
    out = torch.empty((ni, nj, nk, f), dtype=torch.float32, device=y.device)
    if y.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("detile: expected 16-byte aligned tensors")
    _build.launch("flip3d_detile", _DETILE_ARGS, y.data_ptr(), ni, nj, nk, f,
                  out.data_ptr())
    detile.launches += 1
    return out


detile.launches = 0


# ---------------------------------------------------------------------------
# K7: per-particle rows of an F-major tile image
# ---------------------------------------------------------------------------

MAX_GATHER_LANES = 372   # 33 words of shared memory per lane, 48 KB a block


def gather_rows_ref(keys, covered, cols_fw, f_logical=None):
    """Plain version of gather_rows: the image's first f_logical lanes
    turned W-major, indexed by key, masked."""
    f = cols_fw.shape[1] if f_logical is None else f_logical
    wm = cols_fw[:, :f].permute(0, 2, 1).reshape(-1, f)
    rows = wm[keys.long()].float()
    if covered is None:
        return rows
    return torch.where(covered[:, None], rows, torch.zeros_like(rows))


_ROWS_ARGS = (_P,) * 2 + (_I,) + (_P,) + (_I,) * 3 + (_P,) + (_P,)


def gather_rows(keys, covered, cols_fw, f_logical=None):
    """Per-particle rows of an F-major tile image (K7):
    rows[p, f] = cols_fw[keys[p] // W, f, keys[p] % W] for f < f_logical.

    keys: (N,) int32 tile-major keys, in any order, every covered key below
    n_tiles * W (not checked on the card: a key past the image reads out of
    bounds, where the plain version raises); covered: (N,) bool or None
    (every particle); cols_fw: (n_tiles, F, W) f32 or bf16
    (stack_tile_major_fw pads F to a multiple of 8, so pass the logical
    column count to leave the pad lanes out; None: all F). Returns
    (N, f_logical) f32: a bf16 value widened exactly, zero rows for
    uncovered particles."""
    f = cols_fw.shape[1] if f_logical is None else f_logical
    if not 0 <= f <= cols_fw.shape[1]:
        raise ValueError(f"gather_rows: f_logical {f} outside the image's "
                         f"{cols_fw.shape[1]} lanes")
    if _build.on_cpu(keys, "gather_rows"):
        return gather_rows_ref(keys, covered, cols_fw, f)
    n = keys.shape[0]
    _build.require(keys, "keys", torch.int32, (n,))
    if covered is not None:
        _build.require(covered, "covered", torch.bool, (n,))
    _build.require(cols_fw, "cols_fw", (torch.float32, torch.bfloat16),
                   (cols_fw.shape[0], cols_fw.shape[1], W))
    if f > MAX_GATHER_LANES:
        raise ValueError(
            f"gather_rows: at most {MAX_GATHER_LANES} lanes, got {f}")
    rows = torch.empty((n, f), dtype=torch.float32, device=keys.device)
    _build.launch(
        "flip3d_gather_rows", _ROWS_ARGS, keys.data_ptr(),
        None if covered is None else covered.data_ptr(), n,
        cols_fw.data_ptr(), int(cols_fw.dtype == torch.bfloat16),
        cols_fw.shape[1], f, rows.data_ptr())
    gather_rows.launches += 1
    return rows


gather_rows.launches = 0


# ---------------------------------------------------------------------------
# MAC sampling through gathered columns: the unfused oracle of gather_mac
# ---------------------------------------------------------------------------

def build_mac_columns(grids_u, grids_v, grids_w, grid_shape,
                      dtype=torch.float32):
    """(n_tiles, f_pad, W) F-major per-cell columns of `dtype`, grid-major
    lane order: lane (g*3 + comp)*18 + oidx holds grid g of component comp
    at window offset oidx (p2g_abs_offset), 0 outside the face grid. Rows
    [:54] are grid 0's columns."""
    comp_grids = (grids_u, grids_v, grids_w)
    cols = [shifted_read(comp_grids[comp][g], p2g_abs_offset(comp, oidx),
                         grid_shape)
            for g in range(len(grids_u)) for comp in range(3)
            for oidx in range(18)]
    return stack_tile_major_fw(cols, grid_shape, dtype=dtype)


def combine_mac_samples(rows, px, py, pz, keys, dx, grid_shape, n_grids,
                        valid=None):
    """Trilinear combine of gathered (N, >= 54*n_grids) rows ->
    ([u samples], [v samples], [w samples]), one (N,) tensor per grid
    (macvelocityfield.cpp:455-578), zero where `valid` is False."""
    home = decode_key(keys, grid_shape)
    ps = (px, py, pz)
    outs = ([], [], [])
    for comp in range(3):
        fr, delta = [], []
        for ax in range(3):
            f = ps[ax] / dx - _MAC_OFFSETS[comp][ax]
            b = torch.floor(f)
            fr.append(f - b)
            delta.append(b.to(torch.int32) - home[ax])
        for g in range(n_grids):
            out = torch.zeros_like(px)
            for oidx in range(18):
                o = p2g_abs_offset(comp, oidx)
                w = torch.ones_like(px)
                for ax in range(3):
                    corner = o[ax] - delta[ax]
                    w = w * torch.where(
                        corner == 0, 1.0 - fr[ax],
                        torch.where(corner == 1, fr[ax],
                                    torch.zeros_like(fr[ax])))
                out = out + w * rows[:, (g * 3 + comp) * 18 + oidx]
            if valid is not None:
                out = torch.where(valid, out, torch.zeros_like(out))
            outs[comp].append(out)
    return outs
