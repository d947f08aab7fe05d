#!/usr/bin/env python3
"""The benchmark of flipviscosity3d_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell (BENCHMARK.json "workloads") names a configuration
(configs/<config>.json: the scene, its solver settings, its segment and
its output limits) and a traffic mix (traffic/<traffic>.json: keys that
override the configuration's, such as the viscosity). Set-up builds the
scene through FluidSimulation's public API, its particle jitter drawn
from --seed, keeps a device copy of its state, and runs one frame to
build the kernel library and warm every shape. The window then replays
whole segments of the configuration's frames from that copy (window.py)
until --seconds have run out.

--trace 0 prints the cell's end-to-end metrics; --trace 1 runs one segment
under torch.profiler with spans around the program's layers and prints the
per-layer metrics (metrics/<name>.py, each a read(run) that returns a
number or None), the device's busy time and the breakdown. Either way the
substeps recorded in the window are then held against the plain reference
(check.py), every compared number is printed beside its limit on standard
error and under "checks", and the last line of standard output is one JSON
object. The run fails without a result (exit code 2) when there is no CUDA
card, when JAX or the JAX package was imported, or when the cell or its
files are missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, peaks, scene, trace, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flipviscosity3d_tpu")
GB = 1e9


class Refused(Exception):
    """A run that may print no result."""


def process_seconds() -> float:
    """Seconds since this process started (Linux /proc, 10 ms steps)."""
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def find_cell(name: str, bench_file: Path) -> dict:
    if not bench_file.exists():
        raise Refused(f"no {bench_file.name} at {bench_file.parent}")
    bench = json.loads(bench_file.read_text())
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return bench, cell
    raise Refused(f"no workload named {name!r} in {bench_file.name}")


def load_reader(name: str, root: Path):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


@dataclasses.dataclass
class TracedRun:
    """What a per-layer reader reads."""

    spec: dict
    trace: dict
    diags: list
    particles: int
    vcycle_bytes: dict
    hbm_bytes_per_s: float = peaks.HBM_BYTES_PER_S

    @property
    def substeps(self) -> int:
        return sum(d.substeps for d in self.diags)


def check_frames(spec: dict, seed: int) -> list:
    """The frames of a segment whose last substep the check judges, drawn
    from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    frames = int(spec["segment_frames"])
    k = min(int(spec["check_frames"]), frames)
    return sorted(int(f) for f in rng.choice(frames, size=k, replace=False))


def run(args, device, root: Path = HERE, log=None) -> dict:
    """One run of a cell -> its result line (a dict)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench, cell = find_cell(args.workload, root.parent / "BENCHMARK.json")
    spec = scene.load_spec(cell["config"], cell["traffic"], root)
    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.device_count() < int(cell["chips"]):
        raise Refused(f"{args.workload} needs {cell['chips']} cards, "
                      f"{torch.cuda.device_count()} found")
    import flipviscosity3d_torch.core.step as step_mod
    from flipviscosity3d_torch.ops import pallas_mg

    overrides = {}
    if args.control:
        # the program's own lower-precision path: bf16 grid samples and
        # one-term bf16 particle-kernel products
        overrides = dict(pallas_gather_dtype="bf16", pallas_split_terms=1)
    sim = scene.build(scene.program(), spec, args.seed, device, overrides)
    snap = window.snapshot(sim.state)
    particles = int(snap.pos.shape[0])
    log(f"{args.workload}: {particles} particles, "
        f"snapshot {window.snapshot_bytes(snap) / GB:.3f} GB")
    mem = torch.cuda.max_memory_allocated if on_card else (lambda: 0)
    log(f"peak after the scene {mem() / GB:.3f} GB")
    sim._state = snap
    sim.advance(float(spec["frame_dt"]))   # warm-up: builds, warms shapes
    window.sync(device)
    log(f"peak after the warm-up frame {mem() / GB:.3f} GB")
    sim._state = snap
    recorder = window.Recorder(step_mod, check_frames(spec, args.seed))
    traced = {}
    k3_before = pallas_mg.mg_down.launches
    if args.trace:
        substep_span = lambda fn: trace.spanned("substep", fn)  # noqa: E731
        with trace.spans(), recorder.installed(substep_span), \
                trace.profiled(traced), trace.window_span():
            win = window.run(sim, snap, spec, args.seconds, recorder,
                             device, max_segments=1,
                             frame_span=trace.frame_span)
    else:
        with recorder.installed():
            setup_s = process_seconds()
            win = window.run(sim, snap, spec, args.seconds, recorder, device)
    peak = mem()
    del sim
    if on_card:
        torch.cuda.empty_cache()   # room for the reference, peak read
    log(f"window: {win.frames} frames, {win.substeps} substeps, "
        f"{win.segments} segments, {win.seconds:.3f} s, failed {win.failed}, "
        f"peak {peak / GB:.3f} GB")
    grid = (int(spec["resolution"]),) * 3
    cycle_bytes = peaks.vcycle_bytes(grid, spec.get("sim_config", {}))
    levels = peaks.vcycle_launches(grid, spec.get("sim_config", {}))
    counted = sum((d.pressure_iterations + d.substeps) * levels["pressure"]
                  + (d.viscosity_iterations + d.substeps)
                  * levels["viscosity"] * (d.viscosity_tolerance > 0)
                  for d in win.diags)
    log(f"V-cycle cross-check: mg_down launched "
        f"{pallas_mg.mg_down.launches - k3_before}, counted from the "
        f"iterations {counted}")

    metrics = {}
    result = {"correct": False, "attempted": win.frames,
              "failed": win.failed, "metrics": metrics}

    def reported(m) -> bool:
        return args.workload in m.get("workloads", [args.workload])

    if args.trace:
        summary = trace.summarize(traced.pop("events"))
        ctx = TracedRun(spec, summary, win.diags, particles, cycle_bytes)
        for m in bench["per_layer"]:
            if reported(m):
                value = load_reader(m["name"], root)(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        busy = (summary["busy_s"], summary["window_s"])
    else:
        e2e = {
            "substeps_per_s": win.substeps / win.seconds,
            "frame_ms_p90": (statistics.quantiles(win.frame_s, n=10)[8] * 1e3
                             if win.frames >= 2 else None),
            "peak_mem_gb": peak / GB,
            "setup_s": setup_s,
        }
        for m in bench["end_to_end"]:
            if reported(m) and e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        busy = breakdown = None

    records = recorder.records
    n_records = len(records)
    log(f"checking {n_records} of the sampled frames "
        f"{sorted(recorder.frames)}: {sorted(records)}")
    t0 = time.perf_counter()
    gaps = check.judge(records, snap, spec, args.seed, device, log=log)
    del snap
    log(f"reference check took {time.perf_counter() - t0:.1f} s")
    limits = spec["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in check.NAMES}
    result["correct"] = bool(
        win.failed == 0 and n_records > 0
        and all(c["value"] <= c["limit"] for c in checks.values()))
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if busy is not None:
        result["device"]["busy_s"], result["device"]["window_s"] = busy
    if on_card:
        result["device"]["power"] = power_limit()
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="run the program's bf16 path (the check's control)")
    return p.parse_args(argv)


def main(argv=None, device=None, root: Path = HERE) -> int:
    args = parse(argv)
    try:
        if device is None:
            if not torch.cuda.is_available():
                raise Refused("no CUDA device")
            device = "cuda"
        result = run(args, device, root)
        found = forbidden_modules()
        if found:
            raise Refused(f"loaded in this process: {', '.join(found)}")
    except Refused as exc:
        print(f"refused: {exc}", file=sys.stderr, flush=True)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
