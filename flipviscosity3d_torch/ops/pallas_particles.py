"""The particle engine of the port: tile-major keys, the pass-A sort, the
P2G scatter (K1) and the trilinear MAC gather (K2).

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

Both take the plain PyTorch version for CPU tensors and launch their CUDA
kernel (csrc/p2g_scatter.cu, csrc/gather_mac.cu) for CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from .grids import shifted_read

TILE = (8, 8, 8)
W = TILE[0] * TILE[1] * TILE[2]    # cells per tile
N_P2G = 108                         # 54 weight lanes + 54 weight*velocity
FAR = 1.0e8                         # empty-slot position sentinel
MAX_CAP = 32                        # slot table capacity the kernel holds


def check_grid(grid_shape) -> None:
    if any(s % t for s, t in zip(grid_shape, TILE)):
        raise ValueError(
            f"the particle engine needs grid dims divisible by {TILE}; "
            f"got {tuple(grid_shape)}")


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
    n = key_s.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    new_run = torch.ones(n, dtype=torch.bool, device=key.device)
    new_run[1:] = key_s[1:] != key_s[:-1]
    run_start = torch.cummax(
        torch.where(new_run, idx, torch.zeros_like(idx)), dim=0).values
    rank = idx - run_start
    return TiledStream(key_s, rank, pos[perm], vel[perm])


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


# ---------------------------------------------------------------------------
# K1: P2G sums + liquid-SDF slot table
# ---------------------------------------------------------------------------

def scatter_p2g_table_ref(pos_s, vel_s, key_s, rank, grid_shape, dx, cap):
    """Plain version of scatter_p2g_table (index_add over cells)."""
    dev = pos_s.device
    n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]
    gi, gj, gk = decode_key(key_s.long(), grid_shape)
    g = [c.to(torch.float32)[:, None] for c in (gi, gj, gk)]
    lanes = [p2g_abs_offset(l // 18, l % 18) for l in range(54)]
    comp = torch.tensor([l // 18 for l in range(54)], device=dev)
    a = torch.tensor(lanes, dtype=torch.float32, device=dev)      # (54, 3)
    s = torch.tensor([[0.0 if c == ax else 0.5 for ax in range(3)]
                      for c in (l // 18 for l in range(54))],
                     dtype=torch.float32, device=dev)
    f = [(g[ax] + a[:, ax]) * dx - (pos_s[:, ax:ax + 1] - s[:, ax] * dx)
         for ax in range(3)]
    d2 = f[0] * f[0] + f[1] * f[1] + f[2] * f[2]
    c1, c2, c3, r2 = wyvill_constants(dx)
    wgt = 1.0 - c1 * d2 * d2 * d2 + c2 * d2 * d2 - c3 * d2
    wgt = torch.where(d2 < r2, wgt, torch.zeros_like(wgt))
    vsel = vel_s[:, comp]
    vals = torch.cat([wgt, wgt * vsel], dim=1)
    std = (gi * grid_shape[1] + gj) * grid_shape[2] + gk
    sums = torch.zeros((n_cells, N_P2G), dtype=torch.float32, device=dev)
    sums.index_add_(0, std, vals)
    table = torch.zeros((n_cells * cap, 4), dtype=torch.float32, device=dev)
    keep = rank < cap
    slot_vals = torch.cat(
        [pos_s, torch.ones_like(pos_s[:, :1])], dim=1)[keep]
    table[std[keep] * cap + rank[keep].long()] = slot_vals
    return (sums.reshape(*grid_shape, N_P2G),
            table.reshape(*grid_shape, cap, 4))


_P, _I, _F = _build.P, _build.I, _build.F
_SCATTER_ARGS = (_P,) * 4 + (_I,) * 5 + (_F,) * 5 + (_P,) * 2 + (_P,)


def scatter_p2g_table(pos_s, vel_s, key_s, rank, grid_shape, dx, cap):
    """Per-cell P2G sums and liquid-SDF slot table of a tile-key-sorted
    stream -> (sums (I,J,K,108) f32, table (I,J,K,cap,4) f32). Particles of
    rank >= cap are left out of the table only."""
    check_grid(grid_shape)
    if _build.on_cpu(pos_s, "scatter_p2g_table"):
        return scatter_p2g_table_ref(pos_s, vel_s, key_s, rank, grid_shape,
                                     dx, cap)
    n = pos_s.shape[0]
    _build.require(pos_s, "pos_s", torch.float32, (n, 3))
    _build.require(vel_s, "vel_s", torch.float32, (n, 3))
    _build.require(key_s, "key_s", torch.int32, (n,))
    _build.require(rank, "rank", torch.int32, (n,))
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"scatter_p2g_table: cap must be in [1, {MAX_CAP}]")
    ni, nj, nk = grid_shape
    sums = torch.empty((ni, nj, nk, N_P2G), dtype=torch.float32,
                       device=pos_s.device)
    table = torch.empty((ni, nj, nk, cap, 4), dtype=torch.float32,
                        device=pos_s.device)
    c1, c2, c3, r2 = wyvill_constants(dx)
    _build.launch(
        "flip3d_p2g_scatter", _SCATTER_ARGS,
        pos_s.data_ptr(), vel_s.data_ptr(), key_s.data_ptr(),
        rank.data_ptr(), n, ni, nj, nk, cap, _f32(dx), c1, c2, c3, r2,
        sums.data_ptr(), table.data_ptr())
    scatter_p2g_table.launches += 1
    return sums, table


scatter_p2g_table.launches = 0


def table_fields(table, cap):
    """(I,J,K,cap,4) slot table -> (px, py, pz), each (cap, n_cells), with
    FAR in empty slots (the liquid-SDF sweep's slot-major layout)."""
    n_cells = table.shape[0] * table.shape[1] * table.shape[2]
    t = table.reshape(n_cells, cap, 4).permute(1, 0, 2)
    occ = t[..., 3] > 0.5
    far = torch.full_like(t[..., 0], FAR)
    return tuple(torch.where(occ, t[..., f], far) for f in range(3))


def p2g_combine(sums, grid_shape, face_shapes):
    """Per-cell P2G sums -> [(val_sum, w_sum)] per component: face
    f = cell + offset receives the cell's lane."""
    lanes = sums.reshape(-1, N_P2G).t().reshape(N_P2G, *grid_shape)
    acc = []
    for comp in range(3):
        fs = face_shapes[comp]
        vs = torch.zeros(fs, dtype=torch.float32, device=sums.device)
        ws = torch.zeros(fs, dtype=torch.float32, device=sums.device)
        for oidx in range(18):
            neg = tuple(-v for v in p2g_abs_offset(comp, oidx))
            lane = comp * 18 + oidx
            ws = ws + shifted_read(lanes[lane], neg, fs)
            vs = vs + shifted_read(lanes[54 + lane], neg, fs)
        acc.append((vs, ws))
    return acc


# ---------------------------------------------------------------------------
# K2: trilinear MAC samples in the home cell's window
# ---------------------------------------------------------------------------

_MAC_OFFSETS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))


def gather_mac_ref(px, py, pz, keys, grids_u, grids_v, grids_w, dx,
                   grid_shape):
    """Plain version of gather_mac."""
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
            grid = comp_grids[comp][g]
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


_GATHER_ARGS = (_P,) * 4 + (_I,) * 2 + (_P,) * 6 + (_I,) * 3 + (_F,) + (
    _P,) + (_P,)


def gather_mac(px, py, pz, keys, grids_u, grids_v, grids_w, dx, grid_shape):
    """Trilinear MAC samples of n_grids = len(grids_u) in {1, 2} velocity
    grids at each particle -> (3*n_grids, N) f32, rows grid-major
    (g*3 + comp). Only the 2x3x3 window of the particle's (clamped) home cell
    `keys` counts; faces outside a face grid read 0."""
    check_grid(grid_shape)
    n_grids = len(grids_u)
    if n_grids not in (1, 2) or len(grids_v) != n_grids or \
            len(grids_w) != n_grids:
        raise ValueError("gather_mac: 1 or 2 grids per component")
    if _build.on_cpu(px, "gather_mac"):
        return gather_mac_ref(px, py, pz, keys, grids_u, grids_v, grids_w,
                              dx, grid_shape)
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
        n, n_grids, *ptrs, ni, nj, nk, _f32(dx), out.data_ptr())
    gather_mac.launches += 1
    return out


gather_mac.launches = 0
