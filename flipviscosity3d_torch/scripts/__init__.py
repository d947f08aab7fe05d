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
smoke.device_ms (the batch queued behind a head start, the host left out;
a stage that reads a value on the host, as every solve does, cannot leave
it out). On the CPU `device_ms` is None: not measured.
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
    from ..ops import pallas_particles as pp

    lo = torch.tensor([0.02, 0.02, 0.02], device=dev)
    hi = torch.tensor([0.98, 0.27, 0.98], device=dev)
    pos = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    return torch.sort(pp.key_of_position(pos, 1.0 / res, (res,) * 3)).values


def stage(name: str, fn, dev, log=print, repeats: int = 3, **extra):
    """Run fn() once, then time it -> (row, the first call's result). The
    row is {"stage": name, "wall_ms", "device_ms", **extra}: wall_ms by
    time_ms, device_ms by smoke.device_ms over batches of about 50 ms
    (None on the CPU)."""
    out = fn()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    wall = time_ms(fn, dev, repeats=repeats, warmup=0)
    device = None
    if on_card:
        from ..smoke import device_ms

        count = max(1, min(10, int(50.0 / max(wall, 1e-3))))
        device = device_ms(fn, count=count, repeats=repeats)
    row = {"stage": name, "wall_ms": wall, "device_ms": device, **extra}
    dev_s = "not measured" if device is None else f"{device:9.3f} ms"
    log(f"{name:36s} wall {wall:9.3f} ms  device {dev_s}")
    return row, out


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
