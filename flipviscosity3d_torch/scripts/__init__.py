"""The port's counterparts of the JAX package's scripts/: the hardware
checks of the tile-major column path (pallas_hw_check, gather_smem_check,
gather_perf_probe), the round-1 prototype (pallas_particle_proto), the slab
pipeline's collective audit (shard_collectives), the single-device
measurement scripts (profile_substep, pallas_engine_probe, mg_pallas_bench,
mg_profile, solver_microbench, precond_experiment, particle_microbench),
the readiness checks of BASELINE configs 4 and 5 (readiness256,
readiness512), the headline benchmark (bench, bench.py's counterpart), the
hardware blitz over them (hw_blitz, scripts/hw_blitz.sh's) and the scene
driver (run_scene). Each but run_scene is a module with a
`run(device, ...)` function that returns its results as a dict with an
"ok" key, and runs as

    python -m flipviscosity3d_torch.scripts.<name> [--device cuda|cpu]

on the card by default (it raises without one); `--device cpu` runs the
kernels' plain PyTorch versions, at sizes the caller keeps small. The JAX
scripts' environment knobs are flags with the same defaults.

The measurement modules give each stage a row (`stage`): `wall_ms` from
time_ms (CUDA-event batches, the host's launch gaps included, as the JAX
scripts' synced host wall includes its dispatch) and `device_ms` from
device_ms (the batch queued behind a head start, the host left out; a
stage that reads a value on the host, as every solve does, cannot leave it
out). On the CPU `device_ms` is None: not measured. Beside them are the
kernel checks' yardsticks (bound, compare, the stand-in inputs).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time

import torch

from ..config import SimConfig
from ..core.step import _clamp_bounds
from ..ops import pallas_particles as pp

# One NVIDIA H100 SXM, peak rates from its datasheet: HBM bytes/s and the
# float32 rate outside the tensor cores, FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# bytes written between two cold launches: more than the 50 MB L2 holds
FLUSH_BYTES = 256 << 20
# the head start, in device clock cycles, a timed batch is queued behind,
# so that the host's launch cost stays out of the device's time
_HEAD_START_CYCLES = 2_000_000
# the pallas_split_terms settings the particle kernels are held at: the
# exact products (the default) first, then the JAX package's two splits
SPLIT_TERMS = (3, 1, 2)
# particles the revisit probes run over where the whole stream's (N, 128)
# values would not fit the card beside the images (256^3: 18 GB each)
PROBE_RUN = 1 << 23
STALE_LIFT = 0.43   # the lift in y of the stale path's falling pool


def resolve_device(device) -> torch.device:
    """torch.device(device); "cuda" raises where torch sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass --device cpu to run the plain PyTorch "
            "versions on the CPU")
    return dev


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def time_ms(fn, dev="cuda", batch_ms: float = 50.0,
            repeats: int = 3, warmup: int = 2) -> float:
    """Milliseconds of one fn() call: after `warmup` calls, the median
    over `repeats` batches, each of as many back-to-back calls as fill about
    `batch_ms` (1 to 200), divided by that count. A batch is timed by a pair
    of CUDA events on the card and by the host clock on the CPU."""
    on_card = torch.device(dev).type == "cuda"
    for _ in range(warmup):
        fn()
    if on_card:
        torch.cuda.synchronize()

    def batch(count):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(count):
            fn()
        if not on_card:
            return (time.perf_counter() - t0) / count * 1e3
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / count

    count = max(1, min(200, int(batch_ms / max(batch(1), 1e-3))))
    return statistics.median(batch(count) for _ in range(repeats))


def pool_keys(n: int, res: int, gen: torch.Generator, dev) -> torch.Tensor:
    """Sorted int32 tile-major keys of n positions spread uniformly over the
    bottom quarter of the unit box (x, z in [0.02, 0.98], y in [0.02,
    0.27]), as the bench scene's pool is, on a res^3 grid."""
    lo = torch.tensor([0.02, 0.02, 0.02], device=dev)
    hi = torch.tensor([0.98, 0.27, 0.98], device=dev)
    pos = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    return torch.sort(pp.key_of_position(pos, 1.0 / res, (res,) * 3)).values


def sync(device) -> None:
    """torch.cuda.synchronize() where `device` is a card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_ms(fn, flush=None, count: int = 10, repeats: int = 5) -> float:
    """Device milliseconds of one fn() call, the median of `repeats`
    batches. Each batch is queued behind torch.cuda._sleep, so the host has
    enqueued it before the device reaches its first CUDA event, and is
    timed by a pair of events: without `flush`, `count` back-to-back calls
    (inputs warm in L2 where they fit); with `flush`, one call after
    flush() has written past L2 (cold inputs), the flush outside the
    events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        if flush is not None:
            flush()
        torch.cuda._sleep(_HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        calls = 1 if flush is not None else count
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def stage(name: str, fn, dev, log=print, repeats: int = 3, **extra):
    """Run fn() once, then time it -> (row, the first call's result). The
    row is {"stage": name, "wall_ms", "device_ms", **extra}: wall_ms by
    time_ms, device_ms by device_ms over batches of about 50 ms (None on
    the CPU)."""
    out = fn()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    wall = time_ms(fn, dev, repeats=repeats, warmup=0)
    device = None
    if on_card:
        count = max(1, min(10, int(50.0 / max(wall, 1e-3))))
        device = device_ms(fn, count=count, repeats=repeats)
    row = {"stage": name, "wall_ms": wall, "device_ms": device, **extra}
    dev_s = "not measured" if device is None else f"{device:9.3f} ms"
    log(f"{name:36s} wall {wall:9.3f} ms  device {dev_s}")
    return row, out


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the float32 operations over the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


# float32 operations per (particle, window face) of the Wyvill weight and
# its two sums (p2g_wyvill.cuh): 15 for the offset, 5 for d2, 9 for the
# polynomial, 3 to accumulate.
_P2G_FLOPS_PER_FACE = 32


def nbytes(*tensors) -> int:
    """The bytes the tensors hold."""
    return sum(t.numel() * t.element_size() for t in tensors)


def scatter_bound(inputs, n_cells: int, cap: int, stride: int) -> dict:
    """K1's bound: its inputs (positions, velocities, keys, ranks) read
    once, a row of `stride` sums and cap slots written per cell, and the
    Wyvill weights and sums of the 54 window faces of every particle."""
    n = inputs[0].shape[0]
    return bound(nbytes(*inputs) + (4 * stride + 16 * cap) * n_cells,
                 _P2G_FLOPS_PER_FACE * 54 * n)


def stale_scatter_bound(args5, n_cells: int, cap: int, stride: int) -> dict:
    """K5's bound for scatter_p2g_table_stale's arguments (pos, vel, key,
    plan, ...): the particles and the plan read once, a row of `stride`
    sums, cap slots and a count written per cell, and the Wyvill weights and
    sums of the 54 window faces of every covered particle."""
    pos, vel, key, plan = args5[:4]
    return bound(nbytes(pos, vel, key, plan.covered, plan.tile_ptr,
                        plan.tile_chunks)
                 + (4 * stride + 16 * cap + 4) * n_cells,
                 _P2G_FLOPS_PER_FACE * 54 * int(plan.covered.sum()))


def tile_scatter_bound(payload, starts, cap: int, n: int) -> dict:
    """K11's bound: the payload and the run starts read once, a row of 108 +
    4 cap floats written per cell, and the Wyvill weights and sums of the 54
    window faces of each of the n particles."""
    n_cells = (starts.shape[0] - 1) * pp.W
    return bound(nbytes(payload, starts)
                 + 4 * (pp.N_P2G + 4 * cap) * n_cells,
                 _P2G_FLOPS_PER_FACE * 54 * n)


def gather_bound(args) -> dict:
    """K2's bound for gather_mac's arguments (px, py, pz, keys, grids_u,
    grids_v, grids_w, ...): positions, keys and every grid read once, 3
    samples per grid written per particle; per particle 3 divisions and per
    component 12 operations for the axes' fractions and weights, 16 for the
    8 corner weights and 16 per grid to weight and add the corners."""
    px, py, pz, keys, gu, gv, gw = args[:7]
    n, n_grids = px.shape[0], len(gu)
    return bound(nbytes(px, py, pz, keys, *gu, *gv, *gw) + 12 * n_grids * n,
                 (3 + 3 * (12 + 16 + 16 * n_grids)) * n)


def compare(name, got, want, rtol, atol) -> dict:
    """max abs / rel error of got vs want and whether
    |got - want| <= atol + rtol * |want| everywhere. Works through pieces of
    at most 2^27 elements, so that gigabytes of sums need no temporaries of
    their own size."""
    max_abs_err = max_rel = 0.0
    ok = True
    pieces = max(1, -(-got.numel() // (1 << 27)))
    for g, w in zip(got.reshape(-1).chunk(pieces),
                    want.reshape(-1).chunk(pieces)):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        max_abs_err = max(max_abs_err, float(err.max()))
        max_rel = max(max_rel, float((err / w.abs().clamp(min=1e-30)).max()))
        ok = ok and bool((err <= atol + rtol * w.abs()).all()) and bool(
            torch.isfinite(g).all())
    return {"check": name, "max_abs_err": max_abs_err, "max_rel_err": max_rel,
            "rtol": rtol, "atol": atol, "ok": ok}


def max_abs(t) -> float:
    """max |t|, without a temporary of t's size."""
    lo, hi = t.aminmax()
    return max(-float(lo), float(hi))


def equal(name, got, want) -> dict:
    """torch.equal of two outputs, with their largest difference."""
    rec = compare(name, got, want, 0.0, 0.0)
    rec["ok"] = bool(torch.equal(got, want))
    return rec


def midpoints(pos, cfg: SimConfig, gen):
    """Pass B's stand-in midpoints for the kernel checks: the positions
    moved by normal steps of 3 cells per axis, in their order, so that some
    leave the domain -> (mx, my, mz, their tile-major keys, how many lie
    outside)."""
    dx, shape = cfg.dx, cfg.grid_shape
    mid = pos + 3.0 * dx * torch.randn(pos.shape, generator=gen,
                                       device=pos.device)
    outside = int(((mid < 0) | (mid >= shape[0] * dx)).any(dim=1).sum())
    return (*(mid[:, a].contiguous() for a in range(3)),
            pp.key_of_position(mid, dx, shape), outside)


def stale_orders(pos_s, cfg: SimConfig, gen) -> dict:
    """Two stale orders of sorted positions `pos_s`, clamped into the
    domain: "falling" lifts them by the stale path's lift and moves every
    particle down by 0.8 to 1.0 times one CFL substep (cfl_number cells),
    smoothly along x, as one substep of that path's falling pool does;
    "random steps" moves each by uniform steps of up to 1.5 cells per
    axis."""
    dx = cfg.dx
    lo, his = _clamp_bounds(cfg)
    hi = torch.tensor(his, device=pos_s.device)
    x = pos_s[:, 0] / (cfg.isize * dx)
    fall = pos_s.clone()
    fall[:, 1] += STALE_LIFT - cfg.cfl_number * dx * (
        0.8 + 0.2 * torch.sin(2.0 * math.pi * x))
    steps = pos_s + dx * (3.0 * torch.rand(pos_s.shape, generator=gen,
                                           device=pos_s.device) - 1.5)
    return {label: torch.minimum(torch.clamp(p, min=lo), hi)
            for label, p in (("falling", fall), ("random steps", steps))}


def main(run, doc: str, argv=None, **flags) -> int:
    """Command line of one module: --device and one flag per entry of
    `flags` (named without a trailing "_"), its default value (an int, float, str or bool flag) or a
    (type, default) pair for a flag whose default is None; prints run()'s
    result as one JSON line with the card beside it and returns 0 if it is
    ok, else 1."""
    p = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    for name, default in flags.items():
        flag = "--" + name.rstrip("_").replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(flag, dest=name, action="store_true",
                           default=default)
        elif isinstance(default, tuple):
            p.add_argument(flag, dest=name, type=default[0],
                           default=default[1])
        else:
            p.add_argument(flag, dest=name, type=type(default),
                           default=default)
    args = vars(p.parse_args(argv))
    dev = resolve_device(args.pop("device"))
    result = run(dev, **args)
    where = card() if dev.type == "cuda" else "cpu"
    print(json.dumps({**result, "card": where}), flush=True)
    return 0 if result["ok"] else 1
