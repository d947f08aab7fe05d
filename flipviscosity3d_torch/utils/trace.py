"""Spans, stream times and host reads of the substep path.

The program traces exactly when a torch profiler is recording
(`torch.autograd._profiler_enabled()`); it has no switch of its own. Then:

- `span(name)` is a `torch.profiler.record_function` range, so it lands in
  the profiler's timeline on one clock with the kernels launched inside it.
- Inside a `Frame` (core/step.py::advance opens one around its loop), each
  span also records a timing `torch.cuda.Event` on the current stream at
  entry and at exit, taken from a pool kept per thread and reused frame
  after frame, and its host duration. When the frame closes, its own reads
  have drained the stream, and it resolves the markers with
  `Event.elapsed_time` alone, summed by name into
  `{name: {"calls", "host_ms", "stream_ms"}}`. A span's stream time is how
  long the stream took from its start marker to its end marker: its share
  of the frame's critical path, whether the host or the device sets the
  pace. On the CPU, where torch runs each operation to its end before it
  returns, the stream is the calling thread and a span's stream time is
  its host duration. Nested spans count in each enclosing span too.

With no profiler recording, `span` is one check and returns.

`read(site, value)` is how the substep path reads a value from the device.
It counts the read under `site` (always on, per thread: the slab pipeline
runs its solves in rank threads), spans it under the same name, and returns
the host value. A Frame's `host_reads` are the counts of its thread within
the frame.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

_OFF = contextlib.nullcontext()


class _Local(threading.local):
    def __init__(self):
        self.reads = collections.Counter()   # host reads by site
        self.frame = None                    # the open Frame, if any
        self.pool = []                       # timing events, reused


_local = _Local()


class _Span:
    __slots__ = ("name", "_range", "_frame", "_entry")

    def __init__(self, name: str):
        self.name = name
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        self._frame = _local.frame
        if self._frame is not None:
            self._entry = self._frame.open(self.name)
        return self

    def __exit__(self, *exc):
        if self._frame is not None:
            self._frame.close(self._entry)
        return self._range.__exit__(*exc)


def span(name: str):
    """A context manager: a profiler range named `name` (and, inside a
    Frame, its markers) while a profiler records; otherwise nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def read(site: str, value):
    """`value.item()` for a tensor, counted under `site` and spanned under
    that name while a profiler records; any other value passes through
    uncounted."""
    if not isinstance(value, torch.Tensor):
        return value
    _local.reads[site] += 1
    if not torch.autograd._profiler_enabled():
        return value.item()
    with _Span(site):
        return value.item()


class Frame:
    """`with Frame(cuda) as f:` spans the block as "advance"; after it,
    `f.host_reads` holds the block's reads by site, and `f.stages` its spans
    by name (empty unless a profiler recorded; stream times from timing
    events where `cuda`, else the host durations).
    The block must end with a read of the stream that launched its work, so
    that every marker but those recorded after that read has been passed;
    the frame then polls its last marker with cudaEventQuery, never with a
    synchronize."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.stages: dict = {}
        self.host_reads: dict = {}
        self._spans = []   # [name, start marker, end marker, t0, t1]
        self._used = 0     # markers taken from the pool

    def __enter__(self):
        self._before = _local.reads.copy()
        self._prev = _local.frame
        self._on = torch.autograd._profiler_enabled()
        if self._on:
            _local.frame = self
        self._span = span("advance")
        self._span.__enter__()
        return self

    def __exit__(self, typ, exc, tb):
        try:
            self._span.__exit__(typ, exc, tb)
        finally:
            _local.frame = self._prev
        before = self._before
        self.host_reads = {k: n - before.get(k, 0)
                           for k, n in _local.reads.items()
                           if n != before.get(k, 0)}
        if self._on and typ is None:
            self.stages = self._resolve()
        return False

    def _marker(self):
        pool = _local.pool
        if self._used == len(pool):
            pool.append(torch.cuda.Event(enable_timing=True))
        ev = pool[self._used]
        self._used += 1
        ev.record()
        return ev

    def open(self, name: str) -> list:
        entry = [name, self._marker() if self.cuda else None, None,
                 time.perf_counter(), 0.0]
        self._spans.append(entry)
        return entry

    def close(self, entry: list) -> None:
        if self.cuda:
            entry[2] = self._marker()
        entry[4] = time.perf_counter()

    def _resolve(self) -> dict:
        if self.cuda and self._used:
            last = _local.pool[self._used - 1]
            while not last.query():
                time.sleep(0)
        out = {}
        for name, start, end, t0, t1 in self._spans:
            s = out.get(name)
            if s is None:
                s = out[name] = {"calls": 0, "host_ms": 0.0,
                                 "stream_ms": 0.0}
            s["calls"] += 1
            s["host_ms"] += (t1 - t0) * 1e3
            s["stream_ms"] += (start.elapsed_time(end) if self.cuda
                               else (t1 - t0) * 1e3)
        return out

