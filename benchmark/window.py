"""The measured window: whole frames of FluidSimulation.advance, replayed in
fixed segments from the set-up state, and the recorder of the substeps
that the output check judges.

Each segment hands the simulation the snapshot taken at set-up and runs
`segment_frames` frames of `frame_dt` from it, so every run times the same
simulated frames whatever the program's speed. A frame is one
sim.advance(frame_dt) followed by torch.cuda.synchronize(). The window
ends after the segment during which `seconds` ran out, so that it holds
whole segments: frames of a segment differ in substeps and cost (the first
starts from rest), and a window cut after any frame would weigh them by
where the clock happened to run out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

STATE_FIELDS = ("pos", "vel", "u", "v", "w")


def snapshot(state):
    """A device copy of every tensor of a SimState."""
    solid = dataclasses.replace(state.solid, **{
        f.name: getattr(state.solid, f.name).clone()
        for f in dataclasses.fields(state.solid)})
    return state.replace(
        solid=solid, viscosity=state.viscosity.clone(),
        gravity=state.gravity.clone(),
        **{k: getattr(state, k).clone() for k in STATE_FIELDS})


def snapshot_bytes(snap) -> int:
    tensors = [getattr(snap, k) for k in STATE_FIELDS + ("viscosity",
                                                         "gravity")]
    tensors += [getattr(snap.solid, f.name)
                for f in dataclasses.fields(snap.solid)]
    return sum(t.numel() * t.element_size() for t in tensors)


def _copy(state):
    return state.replace(**{k: getattr(state, k).clone()
                            for k in STATE_FIELDS})


@dataclasses.dataclass
class Record:
    """The last substep of a sampled frame: the state it started from, the
    time already advanced in its frame (f32), its dt and index, and the
    state and diagnostics it returned."""

    frame: int
    substep: int
    t_before: np.float32
    dt: float
    state_in: object
    state_out: object
    diag: dict


class Recorder:
    """Wraps the program's substep (core.step.step, which advance looks up
    by name on every substep) to keep, for the frames of a segment listed
    in `frames`, the frame's last substep. A later segment's record of the
    same frame replaces an earlier one, so the records are the window's
    last occurrence of each sampled frame. A record holds device copies of
    the dynamic tensors (STATE_FIELDS) of both states, so that the memory
    a run holds for it is the same whichever frames the seed draws."""

    def __init__(self, step_module, frames):
        self.step_module = step_module
        self.frames = set(frames)
        self.records: dict[int, Record] = {}
        self.frame = None
        self.t = np.float32(0.0)
        self.k = 0

    def start_frame(self, index: int) -> None:
        self.frame, self.t, self.k = index, np.float32(0.0), 0

    @contextlib.contextmanager
    def installed(self, wrap=None):
        real = self.step_module.step
        inner = wrap(real) if wrap else real

        def step(state, dt, cfg, substep_idx=None):
            out = inner(state, dt, cfg, substep_idx=substep_idx)
            if self.frame in self.frames:
                self.records.pop(self.frame, None)
                self.records[self.frame] = Record(
                    self.frame, self.k, self.t, dt, _copy(state),
                    _copy(out[0]), out[1])
            self.t = np.float32(self.t + np.float32(dt))
            self.k += 1
            return out

        self.step_module.step = step
        try:
            yield self
        finally:
            self.step_module.step = real


def _nonfinite(state) -> torch.Tensor:
    """On the device: whether a frame's output holds a non-finite value."""
    return torch.stack([~torch.isfinite(getattr(state, k)).all()
                        for k in STATE_FIELDS]).any()


def _solve_failed(diag) -> bool:
    """A solve that ended above its tolerance (the frame's last substep)."""
    if diag.pressure_residual > diag.pressure_tolerance:
        return True
    return (diag.viscosity_tolerance > 0
            and diag.viscosity_residual > diag.viscosity_tolerance)


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    frame_s: list = dataclasses.field(default_factory=list)
    diags: list = dataclasses.field(default_factory=list)
    failed: int = 0
    segments: int = 0

    @property
    def frames(self) -> int:
        return len(self.frame_s)

    @property
    def substeps(self) -> int:
        return sum(d.substeps for d in self.diags)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(sim, snap, spec, seconds: float, recorder: Recorder, device,
        max_segments: int | None = None, frame_span=None) -> Window:
    """Whole segments of spec["segment_frames"] frames from `snap` until
    `seconds` have run out (or `max_segments` segments are done); returns
    the frames' wall times, diagnostics and failures. A frame fails if it
    raises (its segment then starts over), leaves a non-finite value in
    the state, or ends a solve above its tolerance."""
    frames, dt = int(spec["segment_frames"]), float(spec["frame_dt"])
    span = frame_span or contextlib.nullcontext
    win = Window()
    nonfinite, solve_failed = [], []
    sync(device)
    t_start = time.perf_counter()
    done = False
    while not done:
        sim._state = snap
        win.segments += 1
        for f in range(frames):
            recorder.start_frame(f)
            t0 = time.perf_counter()
            try:
                with span():
                    diag = sim.advance(dt)
                sync(device)
            except Exception as exc:
                print(f"frame {win.frames} raised: {exc!r}", file=sys.stderr,
                      flush=True)
                win.failed += 1
                diag = None
            win.frame_s.append(time.perf_counter() - t0)
            if diag is None:
                break
            win.diags.append(diag)
            nonfinite.append(_nonfinite(sim._state))
            solve_failed.append(_solve_failed(diag))
        if time.perf_counter() - t_start >= seconds or (
                max_segments is not None and win.segments >= max_segments):
            done = True
    win.seconds = time.perf_counter() - t_start
    if nonfinite:
        bad = torch.stack(nonfinite).cpu().tolist()
        win.failed += sum(a or b for a, b in zip(bad, solve_failed))
    return win
