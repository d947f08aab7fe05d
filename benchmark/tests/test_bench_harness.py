"""The benchmark's harness on the CPU: a tiny test-only cell run end to end
with the program's plain kernels, the contract of BENCHMARK.json, the
lookup of cells by name, the trace reduction, and the imports."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import peaks, run, trace

BENCH = Path(run.__file__).resolve().parent
ROOT = BENCH.parent
TINY = BENCH / "tests" / "tiny16.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "flipviscosity3d_tpu"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_checkout(tmp_path: Path, configs=("tiny16",)) -> Path:
    """A copy of benchmark/ beside a BENCHMARK.json that adds a cell under
    each traffic mix for each of `configs` (config files copied from the
    test data) to every per-layer metric."""
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in configs:
        shutil.copy(TINY, dst / "configs" / f"{name}.json")
        for traffic in ("visc5", "inviscid"):
            cell = f"{name}.{traffic}"
            bench["workloads"].append({"name": cell, "config": name,
                                       "traffic": traffic, "chips": 1,
                                       "why": "test"})
            for m in bench["per_layer"] + bench["end_to_end"]:
                m.setdefault("workloads", []).append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run_cell(capsys, root, cell="tiny16.visc5", seed=3_000_000_019,
             trace_on=0, extra=()):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "1", "--trace", str(trace_on), *extra], device="cpu",
                  root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("trace_on", [0, 1])
def test_tiny_cell_prints_the_result_line(tmp_path, capsys, trace_on):
    line = run_cell(capsys, make_checkout(tmp_path), trace_on=trace_on)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert set(line) - set(keys) - {"checks"} <= (
        {"breakdown"} if trace_on else set())
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace_on else "end_to_end"
    want = {m["name"] for m in bench[kind]} - {"frame_ms_p90"}
    assert set(line["metrics"]) >= want - {"kernel.vcycle_roofline"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    if trace_on:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0


def test_dropped_config_is_picked_up(tmp_path, capsys):
    root = make_checkout(tmp_path, configs=("tiny16", "tiny16b"))
    line = run_cell(capsys, root, cell="tiny16b.inviscid")
    assert line["correct"] is True
    assert "substeps_per_s" in line["metrics"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "pool128.visc5", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_unknown_cell_no_result(tmp_path, capsys):
    rc = run.main(["--workload", "nope.visc5", "--seed", "1", "--seconds",
                   "1"], device="cpu", root=make_checkout(tmp_path))
    assert rc != 0 and capsys.readouterr().out == ""


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert (ROOT / bench["command"][1]).is_file()
    cells = bench["workloads"]
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        assert any(w["config"] == c["name"] for w in cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        # the layer as PERF.md's table of layers names it
        assert f"\n| {m['layer']} |" in (ROOT / "PERF.md").read_text()
    every = (names + [w["name"] for w in cells] + [m["name"] for m in metrics]
             + [w["traffic"] for w in cells]
             + [k for c in bench["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in every), every
    for group in (names, [w["name"] for w in cells],
                  [m["name"] for m in metrics]):
        assert len(group) == len(set(group))
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


def test_no_jax_and_a_reference_apart_from_the_program():
    for path in BENCH.rglob("*.py"):
        if "tests" not in path.parts:
            assert not _imports(path) & FORBIDDEN, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert not _imports(path) & {"flipviscosity3d_torch", "benchmark"}, \
            path
        depth = len(path.relative_to(BENCH / "reference").parts)
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.level <= depth, (path, node.module)


def test_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, runpy; sys.argv = ['run.py', '--help'];\n"
            "try: runpy.run_path('benchmark/run.py', run_name='__main__')\n"
            "except SystemExit: pass\n"
            "import benchmark.reference.core.step, benchmark.check\n"
            "import flipviscosity3d_torch.core.step\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            f"{set(FORBIDDEN)!r}\n"
            "print(sorted(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_level_shapes_follow_the_program():
    from flipviscosity3d_torch import smoke
    from flipviscosity3d_torch.config import SimConfig

    for res in (16, 128, 256):
        cfg = SimConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res)
        want = smoke.vcycle_level_shapes(cfg.grid_shape, cfg)
        got = peaks.level_shapes(cfg.grid_shape, {})
        assert {k: [tuple(s) for s in v] for k, v in got.items()} == \
            {k: [tuple(s) for s in v] for k, v in want.items()}
    # the bench substep's 217.3 K3 launches (PERF.md): 4 pressure levels
    # and 5 viscosity levels at 128^3
    assert peaks.vcycle_launches((128,) * 3, {}) == {"pressure": 4,
                                                     "viscosity": 5}


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_summarize_counts_launches_syncs_busy_and_gaps():
    events = [
        _ev("user_annotation", "window", 0, 100),
        _ev("user_annotation", "frame", 0, 60),
        _ev("user_annotation", "pressure_solve", 5, 40),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=1),
        _ev("kernel", "void mg_down_kernel<float>", 12, 8, tid=7, corr=1),
        _ev("cpu_op", "aten::item", 20, 15),
        _ev("cuda_runtime", "cudaMemcpyAsync", 21, 1, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 22, 1, tid=7, corr=2),
        _ev("cuda_runtime", "cudaStreamSynchronize", 23, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=3),
        _ev("kernel", "void mg_up_kernel<float>", 52, 10, tid=7, corr=3),
        # after the frame: the harness's own work
        _ev("cuda_runtime", "cudaDeviceSynchronize", 62, 2),
        _ev("cuda_runtime", "cudaLaunchKernel", 70, 1, corr=4),
        _ev("kernel", "void harness_kernel", 72, 8, tid=7, corr=4),
    ]
    s = trace.summarize(events)
    assert s["launches"] == 3 and s["syncs"] == 1
    assert s["busy_s"] == pytest.approx(27e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["k34_s"] == pytest.approx(18e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"pressure_solve / python": 41e-6,
                                  "pressure_solve / cudaMemcpyAsync": 2e-6,
                                  "window / python": 30e-6})
