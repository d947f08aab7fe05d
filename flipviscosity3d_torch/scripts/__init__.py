"""The port's hardware checks of the tile-major column path, counterparts
of the JAX package's scripts/pallas_hw_check.py, gather_smem_check.py and
gather_perf_probe.py. Each is a module with a `run(device, ...)` function
that returns its results as a dict with an "ok" key, and runs as

    python -m flipviscosity3d_torch.scripts.<name> [--device cuda|cpu]

on the card by default (it raises without one); `--device cpu` runs the
kernels' plain PyTorch versions, at sizes the caller keeps small.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


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
            repeats: int = 3) -> float:
    """Milliseconds of one fn() call: after two warm-up calls, the median
    over `repeats` batches, each of as many back-to-back calls as fill about
    `batch_ms` (1 to 200), divided by that count. A batch is timed by a pair
    of CUDA events on the card and by the host clock on the CPU."""
    on_card = torch.device(dev).type == "cuda"
    for _ in range(2):
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
    from ..ops import pallas_particles as pp

    lo = torch.tensor([0.02, 0.02, 0.02], device=dev)
    hi = torch.tensor([0.98, 0.27, 0.98], device=dev)
    pos = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    return torch.sort(pp.key_of_position(pos, 1.0 / res, (res,) * 3)).values


def main(run, doc: str, argv=None, **sizes) -> int:
    """Command line of one check: --device and one integer flag per entry
    of `sizes` (its defaults); prints run()'s result as one JSON line with
    the card beside it and returns 0 if it is ok, else 1."""
    p = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    for name, default in sizes.items():
        p.add_argument("--" + name.replace("_", "-"), type=int,
                       default=default)
    args = vars(p.parse_args(argv))
    dev = resolve_device(args.pop("device"))
    result = run(dev, **args)
    where = card() if dev.type == "cuda" else "cpu"
    print(json.dumps({**result, "card": where}), flush=True)
    return 0 if result["ok"] else 1
