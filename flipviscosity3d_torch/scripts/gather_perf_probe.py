"""The revisit probes: a W-major row scatter and row gather over sorted
tile-major keys, exact against plain oracles and timed.

    python -m flipviscosity3d_torch.scripts.gather_perf_probe \\
        [--device cpu] [--res 128] [--n 262144] [--bench-n 4111806]

Counterpart of the JAX package's scripts/gather_perf_probe.py, whose two
kernels ran one grid step per (tile, chunk) visit:

- scatter_revisit (K9): out[key // W, key % W, :] += vals[p, :];
- gather_revisit (K10): out[p, :] = cols[key // W, key % W, :];

at N = 262,144 sorted keys spread like the bench pool on 128^3 with F = 128
floats per row, then at the bench scale (N = 4,111,806). The JAX script's
third variant, scatterS, asks whether localising the keys from a TPU SMEM
scalar inside the kernel is slow. The port's scatter takes absolute int32
keys and finds each cell's run in the kernel always, so it has one form;
the pre-localised per-visit key table is TPU plumbing and is not built.
Exits 1 on any mismatch.
"""

from __future__ import annotations

import sys

import torch

from .. import _build
from ..ops import pallas_particles as pp
from . import main, pool_keys, resolve_device, time_ms

C, W = pp.C, pp.W
F = 128
_P, _I = _build.P, _build.I


def scatter_revisit_ref(keys, vals, n_tiles):
    """Plain version of scatter_revisit: index_add_ into zeros."""
    f = vals.shape[-1]
    out = torch.zeros((n_tiles * W, f), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, keys.long(), vals.reshape(-1, f)[:keys.shape[0]])
    return out.reshape(n_tiles, W, f)


_SCATTER_ARGS = (_P, _I, _P, _I, _I, _P, _P)


@_build.counted
def scatter_revisit(keys, vals, n_tiles):
    """out[key // W, key % W, :] += vals[p, :] over keys sorted ascending
    (K9) -> (n_tiles, W, F) f32, zero in cells no particle touches. keys:
    (N,) int32; vals: (n_chunks, C, F) f32, of which the first N rows count.
    Each cell's rows are added in stream order, so two calls agree bit for
    bit. The keys must be sorted and every key below n_tiles * W (neither is
    checked on the card: a key past the image is dropped, where the plain
    version raises)."""
    if _build.on_cpu(keys, "scatter_revisit"):
        return scatter_revisit_ref(keys, vals, n_tiles)
    n = keys.shape[0]
    f = vals.shape[-1]
    _build.require(keys, "keys", torch.int32, (n,))
    _build.require(vals, "vals", torch.float32, (pp.n_chunks(n), C, f))
    out = torch.empty((n_tiles, W, f), dtype=torch.float32,
                      device=keys.device)
    _build.launch("flip3d_scatter_revisit", _SCATTER_ARGS, keys.data_ptr(),
                  n, vals.data_ptr(), n_tiles * W, f, out.data_ptr())
    _build.count(scatter_revisit)
    return out


def gather_revisit_ref(keys, cols):
    """Plain version of gather_revisit: indexing, then the pad rows."""
    n = keys.shape[0]
    f = cols.shape[-1]
    out = torch.zeros((pp.n_chunks(n) * C, f), dtype=cols.dtype,
                      device=cols.device)
    out[:n] = cols.reshape(-1, f)[keys.long()]
    return out


_GATHER_ARGS = (_P, _I, _I, _P, _I, _P, _P)


@_build.counted
def gather_revisit(keys, cols):
    """out[p, :] = cols[key // W, key % W, :] (K10) -> (n_chunks * C, F)
    f32, the rows past N zero. keys: (N,) int32, in any order, every key
    below n_tiles * W (not checked on the card: a key past the image reads
    out of bounds, where the plain version raises); cols: (n_tiles, W, F)
    f32."""
    if _build.on_cpu(keys, "gather_revisit"):
        return gather_revisit_ref(keys, cols)
    n = keys.shape[0]
    f = cols.shape[-1]
    _build.require(keys, "keys", torch.int32, (n,))
    _build.require(cols, "cols", torch.float32, (cols.shape[0], W, f))
    n_rows = pp.n_chunks(n) * C
    out = torch.empty((n_rows, f), dtype=torch.float32, device=keys.device)
    if cols.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("gather_revisit: expected 16-byte aligned tensors")
    _build.launch("flip3d_gather_revisit", _GATHER_ARGS, keys.data_ptr(), n,
                  n_rows, cols.data_ptr(), f, out.data_ptr())
    _build.count(gather_revisit)
    return out


# the scatter adds each cell's rows in stream order, index_add_ on the card
# in the order its atomics land: a few roundings of sums of ~8 values of
# unit scale
SCATTER_RTOL, SCATTER_ATOL = 1e-5, 1e-5


def run(device="cuda", res: int = 128, n: int = 262_144,
        bench_n: int = 4_111_806, seed: int = 0, batch_ms: float = 50.0,
        log=print) -> dict:
    """Both probes at N = n, then at N = bench_n -> {"ok", "checks": [...]}
    with, per size: the scatter within SCATTER_RTOL / SCATTER_ATOL of
    scatter_revisit_ref and bit-equal between two calls, the gather exact,
    and both times."""
    dev = resolve_device(device)
    n_tiles = (res // 8) ** 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cols = torch.randn((n_tiles, W, F), generator=gen, device=dev)
    checks = []
    for count in (n, bench_n):
        keys = pool_keys(count, res, gen, dev)
        assert int(keys.max()) < n_tiles * W   # the kernels do not check
        vals = torch.randn((pp.n_chunks(count), C, F), generator=gen,
                           device=dev)
        touched = int(torch.unique(keys // W).numel())
        log(f"N={count}: chunks={pp.n_chunks(count)} tiles_touched={touched}")
        out = scatter_revisit(keys, vals, n_tiles)
        ref = scatter_revisit_ref(keys, vals, n_tiles)
        err = float((out - ref).abs().max())
        s_ok = bool(torch.allclose(out, ref, rtol=SCATTER_RTOL,
                                   atol=SCATTER_ATOL))
        same = bool(torch.equal(out, scatter_revisit(keys, vals, n_tiles)))
        del out, ref
        s_ms = time_ms(lambda: scatter_revisit(keys, vals, n_tiles), dev,
                       batch_ms)
        log(f"scatterR max|err|={err:.2e} repeatable={same} "
            f"warm {s_ms:9.3f} ms")
        del vals
        g_ok = bool(torch.equal(gather_revisit(keys, cols),
                                gather_revisit_ref(keys, cols)))
        g_ms = time_ms(lambda: gather_revisit(keys, cols), dev,
                       batch_ms)
        log(f"gatherR exact={g_ok} warm {g_ms:9.3f} ms")
        checks.append({"n": count, "tiles_touched": touched,
                       "scatter_max_abs_err": err, "scatter_ok": s_ok,
                       "scatter_repeatable": same, "scatter_ms": s_ms,
                       "gather_ok": g_ok, "gather_ms": g_ms,
                       "ok": s_ok and same and g_ok})
    return {"check": "gather_perf_probe", "res": res, "F": F,
            "ok": all(c["ok"] for c in checks), "checks": checks}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=128, n=262_144, bench_n=4_111_806))
