"""The round-1 particle-kernel prototype: a tile scatter (K11) and a tile
gather (K12) over particles sorted by tile-major cell key, checked and
timed against the two plain baselines they were built to replace.

    python -m flipviscosity3d_torch.scripts.pallas_particle_proto \\
        [--device cpu] [--res 128]

Counterpart of the JAX package's scripts/pallas_particle_proto.py, with its
functions and array layouts, so that both can be fed the same arrays:

- make_scene(res): the bench pool's particles (the bottom 27% of the box, 8
  per cell, jittered) from a numpy seed, velocities standard normal;
- sort_particles: the (8, N + 2C) float32 payload [px, py, pz, vx, vy, vz,
  key, rank] sorted by tile-major key, with 2C pad lanes of key -1, the
  tiles' run starts (n_blocks + 1,) and each chunk's first and last tile
  (n_chunks, 2);
- make_scatter_kernel(n_blocks, nt, dx, cap): per cell of every tile, 54
  Wyvill weights, 54 weight * velocity sums and a cap x [px, py, pz, 1]
  slot table -> (n_blocks, 512, 108 + 4 cap) (`tile_scatter`);
- make_gather_kernel(n_blocks, n_chunks, n_cols): each lane's row of
  per-cell stacked columns, zero for a pad lane -> (n_chunks * C, n_cols)
  (`tile_gather`).

The callables launch the CUDA kernels of csrc/tile_proto.cu on the card and
their plain PyTorch versions (`*_ref`) on the CPU. `run` checks both at
16^3 (the JAX script's checks), then times the sort, both kernels and the
two baselines of the JAX script in PyTorch: six column index_put_ into
(cap * n_cells) tables, and one (N, 54) row index_select. Prints one JSON
line with the card; exits 1 on a mismatch.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import _build
from ..ops.buckets import run_ranks
from ..ops.stream_transfers import _wyvill_weight
from . import main as check_main
from . import resolve_device, time_ms

TILE = (8, 8, 8)
W = TILE[0] * TILE[1] * TILE[2]
C = 512        # particles per chunk
N_SUM = 108    # 54 weights + 54 weight * velocity per cell
MAX_CAP = 32   # the kernel's table lanes: four per thread of a warp
# particles whose per-particle values the plain scatter holds at once
REF_RUN = 1 << 21

_P, _I, _F = _build.P, _build.I, _build.F
_I64 = ctypes.c_int64


def tile_major_key(idx, grid_shape):
    """(..., 3) integer cell coordinates -> tile-major flat key."""
    ti, tj, tk = (idx[..., a] // TILE[a] for a in range(3))
    li, lj, lk = (idx[..., a] % TILE[a] for a in range(3))
    nt = [grid_shape[a] // TILE[a] for a in range(3)]
    tile = (ti * nt[1] + tj) * nt[2] + tk
    local = (li * TILE[1] + lj) * TILE[2] + lk
    return tile * W + local


def make_scene(res=128, fill=0.27, ppc=8, seed=0):
    """(pos, vel, dx, shape): numpy float32 particles of a pool filling the
    bottom `fill` of the res^3 box, `ppc` jittered per cell."""
    rng = np.random.default_rng(seed)
    shape = (res, res, res)
    nj_fill = int(res * fill)
    ii, jj, kk = np.meshgrid(
        np.arange(res), np.arange(nj_fill), np.arange(res), indexing="ij")
    base = np.stack([ii, jj, kk], -1).reshape(-1, 3).astype(np.float32)
    base = np.repeat(base, ppc, axis=0)
    dx = 1.0 / res
    pos = (base + rng.random((base.shape[0], 3), np.float32)) * dx
    vel = rng.standard_normal((base.shape[0], 3)).astype(np.float32)
    return pos, vel, dx, shape


def n_blocks_of(grid_shape) -> int:
    return (grid_shape[0] * grid_shape[1] * grid_shape[2]) // W


def tile_counts(grid_shape) -> tuple:
    return tuple(s // t for s, t in zip(grid_shape, TILE))


def sort_particles(pos, vel, dx, grid_shape):
    """(N, 3) float32 positions and velocities -> (payload (8, N + 2C) f32
    [px, py, pz, vx, vy, vz, key, rank] sorted by tile-major key (stable),
    the pad lanes 0 with key -1; starts (n_blocks + 1,) int32, the first
    sorted index of each tile; spans (n_chunks, 2) int32, the first and last
    tile of each chunk of C sorted particles)."""
    dev = pos.device
    hi = torch.tensor(grid_shape, device=dev) - 1
    idx = torch.minimum(torch.clamp(torch.floor(pos / dx).to(torch.int64),
                                    min=0), hi)
    key = tile_major_key(idx, grid_shape)
    n = pos.shape[0]
    key_s, order = torch.sort(key, stable=True)
    rank = run_ranks(key_s)
    payload = torch.zeros((8, n + 2 * C), dtype=torch.float32, device=dev)
    payload[0:3, :n] = pos[order].t()
    payload[3:6, :n] = vel[order].t()
    payload[6, :n] = key_s.to(torch.float32)
    payload[7, :n] = rank.to(torch.float32)
    payload[6, n:] = -1.0   # pads never match a cell

    n_blocks = n_blocks_of(grid_shape)
    bounds = torch.arange(n_blocks + 1, device=dev) * W
    starts = torch.searchsorted(key_s, bounds).to(torch.int32)
    chunk = torch.arange((n + C - 1) // C, device=dev)
    first = key_s[torch.clamp(chunk * C, max=n - 1)] // W
    last = key_s[torch.clamp((chunk + 1) * C - 1, max=n - 1)] // W
    spans = torch.stack([first, last], dim=1).to(torch.int32)
    return payload, starts, spans


# ---------------------------------------------------------------------------
# K11 tile_scatter
# ---------------------------------------------------------------------------

def _lane_geometry(device):
    """Per lane q = comp * 18 + oidx of the 54 (component, offset) pairs:
    the face offset along (x, y, z), the particle shift in dx (0.5 across
    the component's axis), and the component."""
    q = torch.arange(54, device=device)
    comp, oidx = q // 18, q % 18
    ox, oy, oz = oidx // 9, (oidx // 3) % 3 - 1, oidx % 3 - 1
    ax = torch.where(comp == 0, ox, oy)
    ay = torch.where(comp == 0, oy, torch.where(comp == 1, ox, oz))
    az = torch.where(comp == 2, ox, oz)
    shift = [torch.where(comp == a, 0.0, 0.5) for a in range(3)]
    return ([a.to(torch.float32) for a in (ax, ay, az)],
            [s.to(torch.float32) for s in shift], comp)


def scatter_values(rows, nt, dx, cap):
    """Each particle's contribution to its cell's row: rows (8, n) of the
    payload (real particles) -> (n, 108 + 4 cap) f32, the float expressions
    of the JAX kernel's _scatter_chunk_values in its order."""
    px, py, pz, vx, vy, vz, key, rank = rows
    key = key.to(torch.int64)
    b, local = key // W, key % W
    cell = (b // (nt[1] * nt[2]) * TILE[0] + local // (TILE[1] * TILE[2]),
            (b // nt[2]) % nt[1] * TILE[1] + (local // TILE[2]) % TILE[1],
            b % nt[2] * TILE[2] + local % TILE[2])
    (ax, ay, az), (sx, sy, sz), comp = _lane_geometry(px.device)
    li, lj, lk = (c.to(torch.float32)[:, None] for c in cell)
    fx = (li + ax) * dx - (px[:, None] - sx * dx)
    fy = (lj + ay) * dx - (py[:, None] - sy * dx)
    fz = (lk + az) * dx - (pz[:, None] - sz * dx)
    d2 = fx * fx + fy * fy + fz * fz
    del fx, fy, fz
    wgt = _wyvill_weight(d2, dx)
    del d2
    wv = wgt * torch.stack([vx, vy, vz], dim=1)[:, comp]
    lane = torch.arange(4 * cap, device=px.device)
    slot = torch.stack([px, py, pz, torch.ones_like(px)], dim=1)[:, lane % 4]
    rv = torch.where(rank[:, None] == (lane // 4).to(torch.float32), slot,
                     torch.zeros_like(slot))
    return torch.cat([wgt, wv, rv], dim=1)


def tile_scatter_ref(starts, payload, nt, dx, cap):
    """Plain version of tile_scatter: each particle's values index_add_-ed
    into zeros at its key (in runs of REF_RUN particles)."""
    n_blocks = starts.shape[0] - 1
    n = int(starts[-1])
    out = torch.zeros((n_blocks * W, N_SUM + 4 * cap), dtype=torch.float32,
                      device=payload.device)
    for lo in range(0, n, REF_RUN):
        rows = payload[:, lo:min(n, lo + REF_RUN)]
        out.index_add_(0, rows[6].to(torch.int64),
                       scatter_values(rows, nt, dx, cap))
    return out.reshape(n_blocks, W, -1)


_SCATTER_ARGS = (_P, _P, _I64, _I, _I, _I, _F, _F, _F, _F, _F, _I, _P, _P)


@_build.counted
def tile_scatter(starts, payload, nt, dx, cap):
    """K11: per cell of every 8x8x8 tile, the Wyvill-weight sums and the
    slot table of the cell's particles -> (n_blocks, 512, 108 + 4 cap) f32
    (module docstring; csrc/tile_proto.cu). starts: (n_blocks + 1,) int32
    run starts of the tiles in the payload's sorted keys; payload:
    (8, L) f32 sorted by tile-major key; nt: tiles per axis; cap <= 32.
    Each cell's particles are added in stream order, so two calls agree bit
    for bit."""
    n_blocks = starts.shape[0] - 1
    if nt[0] * nt[1] * nt[2] != n_blocks:
        raise ValueError(f"tile_scatter: {n_blocks} tiles in starts, but "
                         f"nt = {tuple(nt)}")
    if _build.on_cpu(payload, "tile_scatter"):
        return tile_scatter_ref(starts, payload, nt, dx, cap)
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"tile_scatter: cap must be in 1..{MAX_CAP}, got "
                         f"{cap}")
    _build.require(starts, "starts", torch.int32, (n_blocks + 1,))
    _build.require(payload, "payload", torch.float32,
                   (8, payload.shape[-1]))
    f32 = np.float32
    out = torch.empty((n_blocks, W, N_SUM + 4 * cap), dtype=torch.float32,
                      device=payload.device)
    _build.launch(
        "flip3d_tile_scatter", _SCATTER_ARGS, starts.data_ptr(),
        payload.data_ptr(), payload.shape[1], n_blocks, nt[1], nt[2],
        float(f32(dx)), float(f32(dx * dx)),
        float(f32((4.0 / 9.0) / dx**6)), float(f32((17.0 / 9.0) / dx**4)),
        float(f32((22.0 / 9.0) / dx**2)), cap, out.data_ptr())
    _build.count(tile_scatter)
    return out


def make_scatter_kernel(n_blocks, nt, dx, cap):
    """The scatter as the JAX script builds it: a callable (starts,
    payload) -> (n_blocks, 512, 108 + 4 cap); tile_scatter checks that
    starts holds n_blocks tiles."""
    return lambda starts, payload: tile_scatter(starts, payload, nt, dx, cap)


# ---------------------------------------------------------------------------
# K12 tile_gather
# ---------------------------------------------------------------------------

def tile_gather_ref(spans, payload, cols):
    """Plain version of tile_gather: cols.reshape(-1, F)[key], the rows of
    pad lanes zeroed."""
    n_rows = spans.shape[0] * C
    key = payload[6, :n_rows].to(torch.int64)
    rows = cols.reshape(-1, cols.shape[-1])[key.clamp(min=0)]
    return torch.where((key >= 0)[:, None], rows, torch.zeros_like(rows))


_GATHER_ARGS = (_P, _I64, _P, _I, _P, _P)


@_build.counted
def tile_gather(spans, payload, cols):
    """K12: out[p, :] = cols[key_p // 512, key_p % 512, :] for the first
    n_chunks * C lanes of the payload, zero where key < 0 -> (n_chunks * C,
    F) f32 (csrc/tile_proto.cu). spans: (n_chunks, 2) int32, which fixes the
    row count (the kernel reads each lane's key directly, so the spans'
    tiles are not needed); payload: (8, L >= n_chunks * C) f32 whose rows
    are contiguous (a lane slice of the sorted payload is); cols:
    (n_blocks, 512, F) f32. Every key must be below n_blocks * 512 (not
    checked on the card: a key past the columns reads out of bounds, where
    the plain version raises)."""
    if _build.on_cpu(payload, "tile_gather"):
        return tile_gather_ref(spans, payload, cols)
    n_rows = spans.shape[0] * C
    f = cols.shape[-1]
    _build.require(spans, "spans", torch.int32, (spans.shape[0], 2))
    if (payload.dim() != 2 or payload.shape[0] != 8
            or payload.shape[1] < n_rows or payload.stride(1) != 1):
        raise ValueError(
            f"tile_gather: expected an (8, >= {n_rows}) payload with "
            f"contiguous rows, got {tuple(payload.shape)} strides "
            f"{payload.stride()}")
    key = payload[6, :n_rows]
    _build.require(key, "payload key row", torch.float32, (n_rows,))
    _build.require(cols, "cols", torch.float32, (cols.shape[0], W, f))
    out = torch.empty((n_rows, f), dtype=torch.float32, device=cols.device)
    if cols.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("tile_gather: expected 16-byte aligned tensors")
    _build.launch("flip3d_tile_gather", _GATHER_ARGS, key.data_ptr(), n_rows,
                  cols.data_ptr(), f, out.data_ptr())
    _build.count(tile_gather)
    return out


def make_gather_kernel(n_blocks, n_chunks, n_cols):
    """The gather as the JAX script builds it: a callable (spans, payload,
    cols) -> (n_chunks * C, n_cols)."""
    def gather(spans, payload, cols):
        if (spans.shape[0] != n_chunks
                or tuple(cols.shape) != (n_blocks, W, n_cols)):
            raise ValueError(
                f"expected {n_chunks} spans and ({n_blocks}, {W}, {n_cols}) "
                f"columns, got {tuple(spans.shape)} and {tuple(cols.shape)}")
        return tile_gather(spans, payload, cols)
    return gather


# ---------------------------------------------------------------------------
# checks, baselines, command line
# ---------------------------------------------------------------------------

def _wyvill_np(d2, dx):
    return np.where(
        d2 < dx * dx,
        1 - (4 / 9 / dx**6) * d2**3 + (17 / 9 / dx**4) * d2**2
        - (22 / 9 / dx**2) * d2, 0.0)


def check_scatter_correctness(res=16, device="cpu", log=print) -> bool:
    """The JAX script's check: on its 16^3 scene (fill 0.5, 4 per cell,
    seed 1, cap 8), for 20 cells drawn from a numpy seed, the slot table's
    occupancy equals min(particles, cap) and the u weight sum at offset
    (0, 0, 0) equals numpy's to rtol 1e-5 / atol 1e-6. On the card also
    the whole output against the plain version: the slot table exactly,
    the sums to rtol 1e-5 / atol 1e-6 (the plain index_add_ adds with
    atomics in another order), and two calls bit-equal."""
    dev = torch.device(device)
    pos, vel, dx, shape = make_scene(res, fill=0.5, ppc=4, seed=1)
    cap = 8
    payload, starts, _ = sort_particles(torch.from_numpy(pos).to(dev),
                                        torch.from_numpy(vel).to(dev), dx,
                                        shape)
    n_blocks = n_blocks_of(shape)
    nt = tile_counts(shape)
    fn = make_scatter_kernel(n_blocks, nt, dx, cap)
    got = fn(starts, payload)
    out = got.cpu().numpy()
    n = pos.shape[0]
    pay = payload.cpu().numpy()
    keys = pay[6, :n].astype(np.int64)
    rng = np.random.default_rng(0)
    ok = True
    for cell in rng.choice(res**3 // 2, 20, replace=False):
        sel = keys == cell
        b, l = cell // W, cell % W
        occ = out[b, l, N_SUM:].reshape(cap, 4)[:, 3].sum()
        if int(round(occ)) != min(sel.sum(), cap):
            log(f"  occupancy mismatch cell {cell}: {occ} vs {sel.sum()}")
            ok = False
        ti, tj, tk = b // (nt[1] * nt[2]), (b // nt[2]) % nt[1], b % nt[2]
        li = ti * TILE[0] + l // (TILE[1] * TILE[2])
        lj = tj * TILE[1] + (l // TILE[2]) % TILE[1]
        lk = tk * TILE[2] + l % TILE[2]
        px, py, pz = (pay[a, :n][sel] for a in range(3))
        # u component, oidx 4: offset (0, 0, 0)
        d2 = (li * dx - px)**2 + (lj * dx - (py - 0.5 * dx))**2 \
            + (lk * dx - (pz - 0.5 * dx))**2
        want = _wyvill_np(d2, dx).sum()
        if not np.allclose(out[b, l, 4], want, rtol=1e-5, atol=1e-6):
            log(f"  p2g mismatch cell {cell}: {out[b, l, 4]} vs {want}")
            ok = False
    if dev.type == "cuda":
        ref = tile_scatter_ref(starts, payload, nt, dx, cap)
        same = bool(torch.equal(got, fn(starts, payload)))
        table = bool(torch.equal(got[..., N_SUM:], ref[..., N_SUM:]))
        sums = bool(torch.allclose(got[..., :N_SUM], ref[..., :N_SUM],
                                   rtol=1e-5, atol=1e-6))
        if not (same and table and sums):
            log(f"  kernel vs plain: two calls equal {same}, table {table},"
                f" sums {sums}")
            ok = False
    log(f"scatter correctness ({res}^3): {'OK' if ok else 'FAIL'}")
    return ok


def check_gather_correctness(res=16, n_cols=128, device="cpu",
                             log=print) -> bool:
    """The JAX script's check: on its 16^3 scene (fill 0.5, 4 per cell,
    seed 2), random columns from a numpy seed; every particle's row equals
    cols[key] exactly and the pad rows are zero."""
    dev = torch.device(device)
    pos, vel, dx, shape = make_scene(res, fill=0.5, ppc=4, seed=2)
    n = pos.shape[0]
    payload, _, spans = sort_particles(torch.from_numpy(pos).to(dev),
                                       torch.from_numpy(vel).to(dev), dx,
                                       shape)
    n_blocks = n_blocks_of(shape)
    n_chunks = (n + C - 1) // C
    cols = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n_blocks, W, n_cols)).astype(np.float32)).to(dev)
    out = make_gather_kernel(n_blocks, n_chunks, n_cols)(
        spans, payload[:, :n_chunks * C], cols)
    keys = payload[6, :n].to(torch.int64)
    ok = (bool(torch.equal(out[:n], cols.reshape(-1, n_cols)[keys]))
          and not bool(out[n:].any()))
    log(f"gather correctness ({res}^3): {'OK' if ok else 'FAIL'}")
    return ok


def column_scatters(payload, n, n_cells, cap):
    """The JAX script's first baseline, in PyTorch: six (cap * n_cells)
    column tables written by index_put_ at rank * n_cells + key, a particle
    of rank >= cap into a guard slot past the table."""
    key = payload[6, :n].to(torch.int64)
    rank = payload[7, :n].to(torch.int64)
    slot = torch.where(rank < cap, rank * n_cells + key,
                       torch.full_like(key, cap * n_cells))
    outs = []
    for f in range(6):
        col = torch.zeros(cap * n_cells + 1, device=payload.device)
        col.index_put_((slot,), payload[f, :n])
        outs.append(col[:-1])
    return outs


def row_gather(payload, n, stacked):
    """The JAX script's second baseline, in PyTorch: one (N, F) row gather
    of per-cell stacked columns by each particle's key."""
    return torch.index_select(stacked, 0, payload[6, :n].to(torch.int64))


def run(device="cuda", res: int = 128, seed: int = 0, batch_ms: float = 50.0,
        log=print) -> dict:
    """The JAX script's main: both checks at 16^3, then at res^3 (cap 16, F
    = 128) the sort, K11, K12 and the two baselines, timed (time_ms) ->
    {"ok", "checks", times in ms, sizes}."""
    dev = resolve_device(device)
    checks = {"scatter_16": check_scatter_correctness(16, dev, log),
              "gather_16": check_gather_correctness(16, 128, dev, log)}
    pos, vel, dx, shape = make_scene(res, seed=seed)
    n = pos.shape[0]
    cap, n_cols = 16, 128
    n_cells = res ** 3
    n_blocks = n_blocks_of(shape)
    n_chunks = (n + C - 1) // C
    log(f"scene: {res}^3, {n} particles, cap {cap}")
    posd = torch.from_numpy(pos).to(dev)
    veld = torch.from_numpy(vel).to(dev)
    payload, starts, spans = sort_particles(posd, veld, dx, shape)
    times = {"sort_ms": time_ms(lambda: sort_particles(posd, veld, dx, shape),
                                dev, batch_ms)}
    scat = make_scatter_kernel(n_blocks, tile_counts(shape), dx, cap)
    times["scatter_ms"] = time_ms(lambda: scat(starts, payload), dev,
                                  batch_ms)
    gath = make_gather_kernel(n_blocks, n_chunks, n_cols)
    lanes = payload[:, :n_chunks * C]
    cols = torch.zeros((n_blocks, W, n_cols), device=dev)
    times["gather_ms"] = time_ms(lambda: gath(spans, lanes, cols), dev,
                                 batch_ms)
    del cols
    times["column_scatters_ms"] = time_ms(
        lambda: column_scatters(payload, n, n_cells, cap), dev, batch_ms)
    stacked = torch.zeros((n_cells, 54), device=dev)
    times["row_gather_ms"] = time_ms(lambda: row_gather(payload, n, stacked),
                                     dev, batch_ms)
    for name, ms in times.items():
        log(f"{name:24s} {ms:9.3f} ms")
    return {"check": "pallas_particle_proto", "res": res, "particles": n,
            "cap": cap, "n_cols": n_cols, "device": str(dev),
            "ok": all(checks.values()), "checks": checks, **times}


def main(argv=None) -> int:
    return check_main(run, __doc__, argv, res=128)


if __name__ == "__main__":
    sys.exit(main())
