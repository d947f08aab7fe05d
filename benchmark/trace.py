"""The traced window: torch.profiler over whole frames, spans around the
calls into the program's layers, and the reduction of the trace to counts,
busy time, idle gaps and the breakdown.

The spans are record_function ranges that the benchmark wraps around the
program's functions for the traced run only (the untraced run has none),
by replacing module attributes that the step looks up on every call. The
trace is read from torch.profiler's Chrome trace, written to a temporary
directory under TMPDIR and deleted once read.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import importlib
import json
import os
import tempfile

import torch

# (module, attribute, span): the substep stages of core/step.py and the two
# solves, as the step and the grid update call them
SPANS = (
    ("flipviscosity3d_torch.core.step", "_pass_a", "pass_a"),
    ("flipviscosity3d_torch.core.step", "liquid_sdf_from_particles",
     "liquid_sdf"),
    ("flipviscosity3d_torch.ops.pallas_particles", "p2g_combine",
     "p2g_combine"),
    ("flipviscosity3d_torch.core.step", "_grid_update", "grid_update"),
    ("flipviscosity3d_torch.solvers.viscosity", "solve_viscosity",
     "viscosity_solve"),
    ("flipviscosity3d_torch.solvers.pressure", "solve_pressure",
     "pressure_solve"),
    ("flipviscosity3d_torch.ops.pallas_particles", "gather_mac", "g2p"),
    ("flipviscosity3d_torch.ops.pallas_particles", "gather_mac_one_grid",
     "midpoint_sample"),
    ("flipviscosity3d_torch.core.step", "solid_pushback_at", "pushback"),
)

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation"} | RUNTIME_CATS
# runtime calls in which the host waits for the device
SYNC_CALLS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D"}


def spanned(name, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return inner


@contextlib.contextmanager
def spans():
    """Install SPANS for the duration of the block."""
    saved = []
    try:
        for mod_name, attr, name in SPANS:
            mod = importlib.import_module(mod_name)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, spanned(name, getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def frame_span():
    return torch.profiler.record_function("frame")


def window_span():
    return torch.profiler.record_function("window")


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the block on the card; on exit, out["events"] holds the
    trace's complete events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out["events"] = [e for e in events
                     if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _merged(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def summarize(events, top: int = 10) -> dict:
    """Counts and times of the traced window (microseconds in the trace,
    seconds out): the window is the "window" span, frames and syncs.
    launches: device operations (kernels, copies, sets) launched from
    inside a frame span; syncs: host waits for the device made inside a
    frame span; busy: the union of device operations' intervals within the
    window; k34: device time of the V-cycle kernels; device_ops: the
    operations that took the most device time; idle_gaps: the time the
    device sat idle, by what the host was doing then (its innermost span
    and innermost operation)."""
    def annotated(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if _cat(e) == "user_annotation" and e["name"] == name)

    frames, window = annotated("frame"), annotated("window")
    if not frames or not window:
        raise RuntimeError("the trace holds no frame or window span")
    w0, w1 = window[0]
    starts = [s for s, _ in frames]

    def in_frames(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= frames[i][1]

    host = [e for e in events if _cat(e) in HOST_CATS]
    main_tid = next(e["tid"] for e in events if _cat(e) == "user_annotation"
                    and e["name"] == "frame")
    launched = {e["args"]["correlation"] for e in host
                if _cat(e) in RUNTIME_CATS and "correlation" in e.get(
                    "args", {}) and in_frames(e["ts"])}
    device = [e for e in events if _cat(e) in DEVICE_CATS]
    launches = sum(1 for e in device
                   if e.get("args", {}).get("correlation") in launched)
    syncs = sum(1 for e in host if _cat(e) in RUNTIME_CATS
                and e["name"] in SYNC_CALLS and in_frames(e["ts"]))
    busy_iv = _merged((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                      for e in device
                      if e["ts"] + e["dur"] > w0 and e["ts"] < w1)
    busy = sum(e - s for s, e in busy_iv)
    by_op = collections.Counter()
    for e in device:
        by_op[e["name"][:80]] += e["dur"]
    k34 = sum(e["dur"] for e in device
              if "mg_down_kernel" in e["name"] or "mg_up_kernel" in e["name"])
    gaps = []
    prev = w0
    for s, e in busy_iv:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = _idle_by_host(gaps, [e for e in host if e.get("tid") == main_tid])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "launches": launches,
        "syncs": syncs,
        "k34_s": k34 * 1e-6,
        "device_ops": [[n, t * 1e-6] for n, t in by_op.most_common(top)],
        "idle_gaps": [[n, t * 1e-6] for n, t in idle.most_common(top)],
    }


def _idle_by_host(gaps, host) -> collections.Counter:
    """Sum each gap's length under the name of the host's innermost span
    and innermost event at the gap's midpoint (events of one thread nest)."""
    host = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    out = collections.Counter()
    stack, i = [], 0
    for s, e in sorted(gaps):
        t = 0.5 * (s + e)
        while i < len(host) and host[i]["ts"] <= t:
            ev = host[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < ev["ts"]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        live = [ev for ev in stack if ev["ts"] + ev["dur"] >= t]
        span = next((ev["name"] for ev in reversed(live)
                     if _cat(ev) == "user_annotation"), "harness")
        inner = live[-1]["name"] if live and _cat(live[-1]) != \
            "user_annotation" else "python"
        out[f"{span} / {inner}"[:80]] += e - s
    return out
