#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name and power limit from nvidia-smi), the torch and
   CUDA versions and the device count; exits non-zero without a CUDA device.
2. Builds the four CUDA kernels from flipviscosity3d_torch/csrc (nvcc,
   sm_90a) and prints the build time and ptxas' register / spill report.
3. Holds each kernel against its plain PyTorch version on the card, at the
   bench scene's shapes (128^3 grid, ~4.1M particles), and times both.
4. Drives the main path through FluidSimulation(device="cuda") on the bench
   scene: one warm frame and 5 frames of dt = 0.01, printing each frame's
   diagnostics, substeps/s, peak memory and the kernels' launch counts
   (reset just before the main path).
5. Prints the card line, one JSON line of kernel records, and as its last
   line {"ok": true, "device": {...}} when every check held; otherwise
   prints what failed and exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 128
FRAMES = 5


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} "
          f"({torch.cuda.get_device_name(0)})", flush=True)

    sys.path.insert(0, ROOT)
    from flipviscosity3d_torch import _build, smoke

    t0 = time.perf_counter()
    info = _build.build()
    print(f"build: {info['seconds']:.1f} s nvcc, {info['path']}")
    print(info["log"].strip(), flush=True)

    failures = []
    sim = smoke.bench_scene("cuda", RES)
    print(f"scene: {RES}^3, {sim.state.pos.shape[0]} particles, set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    records = smoke.check_kernels(sim.state, sim.cfg)
    failures += [f"kernel {r['name']} disagrees with its plain version"
                 for r in records if not r["ok"]]
    del sim
    torch.cuda.empty_cache()

    result = smoke.run_main_path("cuda", RES, FRAMES)
    failures += result["failures"]
    print(json.dumps({
        "particles": result["particles"],
        "timed_frames": FRAMES,
        "substeps": result["substeps"],
        "substeps_per_s": result["substeps_per_s"],
        "peak_bytes": result["peak_bytes"],
        "launches": result["launches"],
        "card": card,
    }), flush=True)

    if failures:
        for f in failures:
            print(f"FAILED: {f}")
        return 1
    kernels = [{k: r[k] for k in ("name", "route", "source", "replaces",
                                  "max_abs_err", "ms", "plain_ms")}
               | {"launches": result["launches"][r["name"]]}
               for r in records]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
