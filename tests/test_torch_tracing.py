"""The port's own tracing (utils/trace.py) on the CPU at 16^3: the spans a
frame emits under torch.profiler and how they nest, that nothing is
recorded and nothing changes without a profiler, the host-read counter
against its formula, and the benchmark's six readers of stages and host
reads on hand-built runs."""

import dataclasses
import importlib.util
import json
import threading
import types
from pathlib import Path
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.state import StepDiagnostics
from flipviscosity3d_torch.scripts.bench import bench_scene
from flipviscosity3d_torch.utils import trace

METRICS = Path(__file__).resolve().parent.parent / "benchmark" / "metrics"
ENGINES = ["pallas", "table", "stream"]
STATE = ("pos", "vel", "u", "v", "w")
# the stages of a substep, each inside a "substep" span; the table and
# stream engines fuse the P2G sums into liquid_sdf and have no p2g_combine
STAGES = ("pass_a", "liquid_sdf", "p2g_combine", "grid_update", "g2p",
          "midpoint_sample", "pushback")
GRID = ("extrapolate", "viscosity_any", "viscosity_build", "viscosity_solve",
        "viscosity_apply", "pressure_build", "pressure_solve",
        "pressure_apply")
PCG = ("pcg.apply_A", "pcg.apply_M", "pcg.read", "pcg.converged")
# each apply of the coupled viscosity operator: the build's RHS coupling
# and, inside pcg.apply_A, the warm start's residual and each iteration's
OPERATOR = ("viscosity_operator",)
# each apply of the viscosity solve's preconditioner, inside pcg.apply_M
PRECOND = ("viscosity_precond",)
FRAME = ("advance", "cfl_read", "substep", "frame_reads", "frame.pressure",
         "frame.viscosity", "frame.liquid_cells", "frame.counts")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The bench pool at 16^3 on the CPU, and per engine one frame of it
    without a profiler and one under torch.profiler (CPU activity), from
    the same state: {engine: (cfg, untraced, traced, chrome events, the
    profiler ranges the untraced frame opened)}, each run a (state,
    StepDiagnostics) pair."""
    torch.set_num_threads(1)
    sim = bench_scene("cpu", 16)
    state, runs = sim.state, {}
    tmp = tmp_path_factory.mktemp("tracing")

    def frames(engine):
        if engine not in runs:
            cfg = dataclasses.replace(sim.cfg, particle_engine=engine)
            opened, real = [], torch.profiler.record_function
            with mock.patch.object(
                    torch.profiler, "record_function",
                    lambda *a, **k: opened.append(a) or real(*a, **k)):
                plain = tstep.advance(state, 0.01, cfg)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                traced = tstep.advance(state, 0.01, cfg)
            path = tmp / f"{engine}.json"
            prof.export_chrome_trace(str(path))
            data = json.loads(path.read_text())
            events = data["traceEvents"] if isinstance(data, dict) else data
            spans = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"]
            runs[engine] = (cfg, plain, traced, spans, opened)
        return runs[engine]

    return frames


def _names(engine):
    names = set(STAGES + GRID + PCG + OPERATOR + PRECOND + FRAME)
    if engine == "pallas":
        names.add("frame.plan_visits")
    else:
        names.discard("p2g_combine")
    return names


def _inside(e, outer) -> bool:
    return any(o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
               for o in outer)


@pytest.mark.parametrize("engine", ENGINES)
def test_traced_frame_emits_the_documented_spans(scene, engine):
    """Under the profiler a frame emits exactly the documented span names,
    nested as documented, and none that the benchmark's summary looks up
    by name ("frame", "window"); its stages count each span's calls."""
    _, _, (_, diag), spans, _ = scene(engine)
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == _names(engine)
    assert not {"frame", "window"} & set(by_name)
    assert {k: s["calls"] for k, s in diag.stages.items()} == {
        k: len(v) for k, v in by_name.items()}
    # on the CPU the stream is the calling thread
    assert all(s["stream_ms"] == s["host_ms"] >= 0
               for s in diag.stages.values())

    def nested(inner, outer):
        for name in inner:
            for e in by_name.get(name, []):
                assert _inside(e, [o for n in outer
                                   for o in by_name[n]]), (name, outer)

    nested(("cfl_read", "substep", "frame_reads"), ("advance",))
    nested(STAGES, ("substep",))
    nested(GRID, ("grid_update",))
    nested(PCG, ("viscosity_solve", "pressure_solve"))
    nested(OPERATOR, ("viscosity_build", "pcg.apply_A"))
    assert len(by_name["viscosity_operator"]) == \
        diag.viscosity_iterations + 2 * diag.substeps
    nested(PRECOND, ("pcg.apply_M",))
    nested(PRECOND, ("viscosity_solve",))
    assert len(by_name["viscosity_precond"]) == \
        diag.viscosity_iterations + diag.viscosity_solves
    nested([n for n in by_name if n.startswith("frame.")], ("frame_reads",))
    assert len(by_name["substep"]) == diag.substeps
    assert len(by_name["advance"]) == 1


@pytest.mark.parametrize("engine", ENGINES)
def test_untraced_frame_records_nothing_and_tracing_changes_nothing(
        scene, engine):
    """Without a profiler no span is opened and stages stay empty; the
    traced frame of the same state ends bit-equal, with equal diagnostics
    apart from stages."""
    _, (s_plain, d_plain), (s_traced, d_traced), _, opened = scene(engine)
    assert opened == [] and d_plain.stages == {} and d_plain.host_reads
    for k in STATE:
        assert torch.equal(getattr(s_plain, k), getattr(s_traced, k)), k
    plain, traced = d_plain.as_dict(), d_traced.as_dict()
    assert traced.pop("stages") != {}
    assert plain.pop("stages") == {}
    assert plain == traced


@pytest.mark.parametrize("engine, viscosity", [
    ("pallas", 5.0), ("table", 5.0), ("stream", 5.0), ("pallas", 0.0)])
def test_host_reads_follow_the_formula(scene, engine, viscosity):
    """host_reads: iterations + 1 convergence reads and one converged read
    a solve, one CFL and one viscosity test a substep, and the frame's
    reads of its diagnostics: two a solve kind that ran, the liquid cells,
    and each substep's counted tensors (the pallas engine's overflow and
    pass-B plan, its plan visits; the other engines' overflow)."""
    cfg, (state, d), _, _, _ = scene(engine)
    if viscosity == 0:
        _, d = tstep.advance(state.replace(
            viscosity=torch.zeros_like(state.viscosity)), 0.01, cfg)
    s = d.substeps
    solves = s * (1 + (viscosity > 0))
    want = {"cfl_read": s, "viscosity_any": s,
            "pcg.read": d.pressure_iterations + d.viscosity_iterations
            + solves,
            "pcg.converged": solves, "frame.pressure": 2,
            "frame.liquid_cells": 1,
            "frame.counts": s * (2 if engine == "pallas" else 1)}
    if viscosity:
        want["frame.viscosity"] = 2
    if engine == "pallas":
        want["frame.plan_visits"] = s
    assert s >= 1 and d.host_reads == want


def test_host_reads_are_counted_per_thread():
    """A read made by another thread while a frame is open does not count
    in the frame's host_reads (the slab pipeline's rank threads)."""
    one = torch.ones(())
    with trace.Frame(False) as frame:
        trace.read("here", one)
        t = threading.Thread(target=trace.read, args=("there", one))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert frame.host_reads == {"here": 1} and frame.stages == {}
    assert trace.read("any", 3.5) == 3.5


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _stage(ms):
    return {"calls": 1, "host_ms": 2.0 * ms, "stream_ms": ms}


def _run(*diags):
    return types.SimpleNamespace(diags=list(diags),
                                 substeps=sum(d.substeps for d in diags))


def _hand_built():
    """Two frames of 2 and 1 substeps with known stages and reads."""
    a = StepDiagnostics(substeps=2, host_reads={"cfl_read": 2, "pcg.read": 40},
                        stages={
        "pass_a": _stage(3.0), "liquid_sdf": _stage(5.0),
        "p2g_combine": _stage(1.0), "g2p": _stage(4.0),
        "midpoint_sample": _stage(2.0), "pushback": _stage(1.0),
        "grid_update": _stage(60.0), "viscosity_build": _stage(4.0),
        "viscosity_solve": _stage(30.0), "viscosity_apply": _stage(1.0),
        "pressure_build": _stage(2.0), "pressure_solve": _stage(10.0),
        "pressure_apply": _stage(1.0), "extrapolate": _stage(6.0),
        "viscosity_operator": _stage(12.0),
        "substep": _stage(80.0), "advance": _stage(85.0)})
    b = StepDiagnostics(substeps=1, host_reads={"cfl_read": 1, "pcg.read": 17},
                        stages={
        "pass_a": _stage(1.0), "liquid_sdf": _stage(2.0),
        "g2p": _stage(3.0), "midpoint_sample": _stage(1.0),
        "pushback": _stage(0.5), "grid_update": _stage(20.0),
        "viscosity_solve": _stage(9.0), "viscosity_operator": _stage(4.5),
        "pressure_solve": _stage(5.5)})
    return a, b


@pytest.mark.parametrize("name, want", [
    ("particle.engine_ms_per_substep", (16.0 + 7.5) / 3),
    ("solver.viscosity_ms_per_substep", (35.0 + 9.0) / 3),
    ("solver.pressure_ms_per_substep", (13.0 + 5.5) / 3),
    ("step.grid_ms_per_substep", ((60.0 - 48.0) + (20.0 - 14.5)) / 3),
    ("step.host_reads_per_substep", (42 + 18) / 3),
    ("solver.viscosity_operator_ms_per_substep", (12.0 + 4.5) / 3),
])
def test_readers_on_a_hand_built_run(name, want):
    """Each reader sums its spans' stream time (or the reads) over the
    frames and divides by the substeps; None where a frame has no stages
    (untraced) or the program lacks the field, and the two viscosity
    readers None where no viscosity solve ran."""
    read = _reader(name)
    a, b = _hand_built()
    assert read(_run(a, b)) == pytest.approx(want, rel=1e-12)
    assert read(_run()) is None
    assert read(_run(types.SimpleNamespace(substeps=2))) is None
    if name == "step.host_reads_per_substep":
        assert read(_run(StepDiagnostics(substeps=2))) == 0
        return
    assert read(_run(a, StepDiagnostics(substeps=1))) is None
    if name in ("solver.viscosity_ms_per_substep",
                "solver.viscosity_operator_ms_per_substep"):
        inviscid = dataclasses.replace(a, stages={
            k: s for k, s in a.stages.items()
            if not k.startswith("viscosity")})
        assert read(_run(inviscid)) is None


def test_operator_reader_is_none_without_its_span():
    """The operator's reader on frames of a program that does not span the
    operator (stages, a viscosity solve, no viscosity_operator): None; on
    frames of which only some hold the span, those frames' stream ms over
    all substeps."""
    read = _reader("solver.viscosity_operator_ms_per_substep")
    a, b = _hand_built()
    bare = [dataclasses.replace(d, stages={
        k: s for k, s in d.stages.items() if k != "viscosity_operator"})
        for d in (a, b)]
    assert read(_run(*bare)) is None
    assert read(_run(a, bare[1])) == pytest.approx(12.0 / 3, rel=1e-12)


def test_viscosity_solves_count_the_viscous_substeps(scene):
    """viscosity_solves: one a substep whose viscosity CG ran, none at
    viscosity 0; viscosity_unconverged: none where every solve converged."""
    cfg, (state, d), _, _, _ = scene("pallas")
    assert d.viscosity_solves == d.substeps >= 1
    assert d.viscosity_unconverged == 0
    assert d.viscosity_residual <= d.viscosity_tolerance
    _, d0 = tstep.advance(state.replace(
        viscosity=torch.zeros_like(state.viscosity)), 0.01, cfg)
    assert d0.substeps >= 1
    assert d0.viscosity_solves == d0.viscosity_unconverged == 0
    assert d0.viscosity_iterations == 0


def test_viscosity_unconverged_counts_a_capped_solve(scene):
    """A viscosity CG cut at one iteration stops above its tolerance: each
    such solve counts in viscosity_unconverged, and no host read is added
    for the count (only apply_viscosity_solution's residual test)."""
    cfg, (state, d), _, _, _ = scene("pallas")
    capped = dataclasses.replace(cfg, viscosity_solve_max_iterations=1)
    _, dc = tstep.advance(state, 0.01, capped)
    assert dc.viscosity_iterations == dc.substeps >= 1
    assert dc.viscosity_unconverged == dc.viscosity_solves == dc.substeps
    assert dc.viscosity_residual > dc.viscosity_tolerance
    extra = {k: n - d.host_reads.get(k, 0) for k, n in dc.host_reads.items()
             if n != d.host_reads.get(k, 0)}
    assert extra.pop("viscosity_residual") == dc.substeps
    assert set(extra) <= {"pcg.read", "cfl_read", "viscosity_any",
                          "frame.counts", "frame.plan_visits"}


@pytest.mark.parametrize("engine", ENGINES)
def test_viscosity_precond_spans_each_apply(scene, engine):
    """Under the profiler viscosity_precond is in StepDiagnostics.stages with
    iterations + 1 calls a viscosity solve; pcg.apply_M holds it and the
    pressure solve's applies besides."""
    _, _, (_, d), _, _ = scene(engine)
    calls = d.stages["viscosity_precond"]["calls"]
    assert calls == d.viscosity_iterations + d.viscosity_solves
    assert d.stages["pcg.apply_M"]["calls"] == \
        calls + d.pressure_iterations + d.substeps
    assert d.stages["viscosity_precond"]["stream_ms"] <= \
        d.stages["pcg.apply_M"]["stream_ms"]


def _traced_run(*diags):
    from benchmark.run import TracedRun
    return TracedRun(spec={}, trace={}, diags=list(diags), particles=0,
                     vcycle_bytes={})


@pytest.mark.parametrize("name, want", [
    ("solver.viscosity_iters_per_solve", (300 + 50) / 3),
    ("solver.viscosity_unconverged_share", 100.0 * 1 / 3),
    ("solver.viscosity_precond_ms_per_substep", (40.0 + 5.0) / 4),
])
def test_viscosity_readers_on_a_hand_built_traced_run(name, want):
    """The three readers of the viscosity counters and span on a TracedRun
    of three frames (2 + 1 viscous substeps, one capped solve, and an
    inviscid substep): None without a viscosity solve, for a program
    without the counters (or the span), and, for the span, untraced."""
    read = _reader(name)
    a = StepDiagnostics(substeps=2, viscosity_iterations=300,
                        viscosity_solves=2, viscosity_unconverged=1,
                        stages={"viscosity_precond": _stage(40.0),
                                "pcg.apply_M": _stage(55.0)})
    b = StepDiagnostics(substeps=1, viscosity_iterations=50,
                        viscosity_solves=1,
                        stages={"viscosity_precond": _stage(5.0)})
    dry = StepDiagnostics(substeps=1, stages={"pcg.apply_M": _stage(3.0)})
    assert read(_traced_run(a, b, dry)) == pytest.approx(want, rel=1e-12)
    assert read(_traced_run()) is None
    assert read(_traced_run(dry)) is None
    parent = [types.SimpleNamespace(
        substeps=d.substeps, viscosity_iterations=d.viscosity_iterations,
        stages={k: s for k, s in d.stages.items()
                if k != "viscosity_precond"}) for d in (a, b)]
    assert read(_traced_run(*parent)) is None
    if name.endswith("ms_per_substep"):
        assert read(_traced_run(dataclasses.replace(a, stages={}))) is None
