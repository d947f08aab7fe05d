"""The hardware measurement blitz: the kernel gate, the devices, the engine
probe, the bench variants and the solver microbench, in that order.

    python -m flipviscosity3d_torch.scripts.hw_blitz [--device cpu]
        [--res 128] [--frames 5]

Counterpart of the JAX repo's scripts/hw_blitz.sh, step by step, each step
with the shell script's time limit:

- 0: pallas_hw_check (the kernel gate; at most 32^3);
- 1: the devices: torch's CUDA devices, the card's name and power limit;
- 2: pallas_engine_probe at res^3 (4.1M particles at 128^3, scaled by
  volume below it);
- 3, 3a, 3b, 3c, 3e, 3f: bench on "pallas" with the shell's flags;
- 3d: solver_microbench at res^3;
- 4: bench on "table";
- 5: the bench step with the most substeps/s, and its engine.

Each step prints one JSON line (its result, wall seconds, the kernels it
launched). A failure of step 0 or 1 stops the run, as in the shell
script; a later step that fails (raises, is not ok, runs past its limit,
or on the card leaves one of its kernels unlaunched) does not stop the
others, but the run then exits 1. Step 5 prints the winner and writes no
file: BENCH_DEFAULT is the JAX repo's marker, read by scripts/bench.py.
--res and --frames size steps 2-4 (bench frames), so that a smoke run and
the CPU tests can run the blitz small.

A step's time limit is enforced with SIGALRM where run() is called from
the main thread (a step past it raises TimeoutError and fails).
"""

from __future__ import annotations

import json
import signal
import sys
import threading
import time
import traceback

import torch

from .. import _build
from . import bench, card, main, pallas_engine_probe, pallas_hw_check
from . import resolve_device, solver_microbench, sync

K1_K4 = ("scatter_p2g_table", "gather_mac", "mg_down", "mg_up")
# (step, what it runs, time limit s, the kernels it must launch on the
# card, bench flags) of hw_blitz.sh's bench steps
BENCH_STEPS = (
    ("3", "bench: pallas engine (committed defaults)", 4000, K1_K4, {}),
    ("3a", "bench: pallas + split_terms=2", 4000, K1_K4,
     {"split_terms": 2}),
    ("3b", "bench: pallas + kernel pushback + sdf cap 8", 4000,
     K1_K4 + ("gather_rows8",), {"pushback": "kernel", "sdf_capacity": 8}),
    ("3c", "bench: pallas + stale pass A (resort 1/frame)", 4000,
     ("scatter_p2g_table_stale",) + K1_K4[1:], {"pass_a": "stale"}),
    ("3e", "bench: pallas + bf16 gather columns", 4000, K1_K4,
     {"gather_dtype": "bf16"}),
    ("3f", "bench: pallas + split_terms=2 + bf16 gather (candidate "
     "default)", 4000, K1_K4, {"split_terms": 2, "gather_dtype": "bf16"}),
)
PROBE_N = 4_100_000   # pallas_engine_probe's particles at 128^3


def devices() -> dict:
    """Step 1: the devices torch sees and the card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"ok": True, "cuda_devices": [torch.cuda.get_device_name(i)
                                         for i in range(n)],
            "card": card() if n else "none"}


def steps(dev, res: int, frames: int) -> list:
    """(step, what, limit s, kernels, fn) in hw_blitz.sh's order."""
    quiet = lambda line: None   # noqa: E731
    bench_args = dict(resolution=res, frames=frames, log=quiet)

    def bench_step(flags, engine="pallas"):
        return lambda: bench.run(dev, engine=engine, **bench_args, **flags)

    out = [
        ("0", "kernel smoke gate (pallas_hw_check)", 600,
         ("scatter_p2g_table", "gather_rows", "detile"),
         lambda: pallas_hw_check.run(dev, res=min(res, 32), log=quiet)),
        ("1", "devices", 120, (), devices),
        ("2", f"pallas engine per-stage probe ({res}^3)", 3000,
         ("scatter_p2g_table", "gather_mac", "scatter_p2g_table_stale",
          "gather_rows8"),
         lambda: pallas_engine_probe.run(
             dev, n=round(PROBE_N * (res / 128) ** 3), res=res, log=quiet)),
    ]
    out += [(s, what, limit, kernels, bench_step(flags))
            for s, what, limit, kernels, flags in BENCH_STEPS]
    out.append(("3d", f"solver microbench (direct solve wall, {res}^3)",
                4000, ("mg_down", "mg_up"),
                lambda: solver_microbench.run(dev, res=res, log=quiet)))
    out.append(("4", "bench: table engine", 4000, ("mg_down", "mg_up"),
                bench_step({}, engine="table")))
    return out


class _Limit:
    """SIGALRM after `seconds` raises TimeoutError in the main thread; a
    no-op elsewhere."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.armed = threading.current_thread() is threading.main_thread()

    def _fire(self, signum, frame):
        raise TimeoutError(f"the step ran past its {self.seconds} s limit")

    def __enter__(self):
        if self.armed:
            self._old = signal.signal(signal.SIGALRM, self._fire)
            signal.setitimer(signal.ITIMER_REAL, self.seconds)
        return self

    def __exit__(self, *exc):
        if self.armed:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, self._old)
        return False


def run_step(dev, step, what, limit, kernels, fn) -> dict:
    """One step -> its line: the result, wall seconds, the kernels it
    launched (counts set to 0 just before), ok and why not."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    why = []
    try:
        with _Limit(limit):
            result = fn()
            sync(dev)
        if not result.get("ok", False):
            why.append("its result is not ok")
    except Exception:   # the blitz goes on; the failure is kept and counted
        result = {"error": traceback.format_exc()}
        why.append("it raised")
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    if dev.type == "cuda" and "error" not in result:
        why += [f"kernel {k} was never launched" for k in kernels
                if not counts.get(k)]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"step": step, "what": what, "limit_s": limit, "wall_s": wall,
            "launches": counts, "ok": not why, "failures": why,
            "result": result}


def run(device="cuda", res: int = 128, frames: int = 5, log=print) -> dict:
    """Every step in order -> {"check", "ok", "steps": each step's
    summary, "failed", "winner": step 5's line}."""
    dev = resolve_device(device)
    lines = []
    for step, what, limit, kernels, fn in steps(dev, res, frames):
        line = run_step(dev, step, what, limit, kernels, fn)
        log(json.dumps(line))
        lines.append(line)
        if step in ("0", "1") and not line["ok"]:
            break
    benches = [ln for ln in lines if ln["ok"]
               and ln["result"].get("check") == "bench"]
    winner = None
    if benches:
        best = max(benches, key=lambda ln: ln["result"]["value"])
        winner = {"step": "5", "engine": best["result"]["engine"],
                  "from_step": best["step"], "what": best["what"],
                  "substeps_per_s": best["result"]["value"]}
        log(json.dumps(winner))
    failed = [ln["step"] for ln in lines if not ln["ok"]]
    return {"check": "hw_blitz", "res": res, "frames": frames,
            "steps": [{k: ln[k] for k in ("step", "ok", "wall_s",
                                          "failures")}
                      | ({"value": ln["result"]["value"]}
                         if "value" in ln["result"] else {})
                      for ln in lines],
            "failed": failed, "winner": winner, "ok": not failed}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=128, frames=5))
