"""The port's bench (flipviscosity3d_torch/scripts/bench.py) and hardware
blitz (scripts/hw_blitz.py) on the CPU.

bench's flags must give FluidSimulation.initialize exactly the arguments
that the JAX repo's bench.py gives it under the matching BENCH_*
environment knobs: both packages' initialize is replaced by a recorder
that stops the run. bench.py is run in a child process, since importing it
sets a JAX compilation cache for the whole process. Then both modules run
from their command lines with --device cpu at 16^3 in a process where jax
cannot be imported: bench prints one JSON line without vs_baseline and
exits non-zero, with no retry on another engine, when its engine fails;
the blitz runs every step of scripts/hw_blitz.sh, writes no file of the
repo, and exits non-zero when a step fails, after running the later ones.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import flipviscosity3d_torch.core.sim as tsim
from flipviscosity3d_torch.scripts import bench, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (bench.py's environment, the port's flags)
KNOB_CASES = [
    ({}, []),
    ({"BENCH_PASS_B": "sort"}, ["--pass-b", "sort"]),
    ({"BENCH_PUSHBACK": "kernel"}, ["--pushback", "kernel"]),
    ({"BENCH_SDF_CAPACITY": "8"}, ["--sdf-capacity", "8"]),
    ({"BENCH_MG_DTYPE": "bf16"}, ["--mg-dtype", "bf16"]),
    ({"BENCH_MIDPOINT_FACTOR": "1.5"}, ["--midpoint-factor", "1.5"]),
    ({"BENCH_GATHER_DTYPE": "bf16"}, ["--gather-dtype", "bf16"]),
    ({"BENCH_SPLIT_TERMS": "2"}, ["--split-terms", "2"]),
    ({"BENCH_PASS_A": "stale"}, ["--pass-a", "stale"]),
    ({"BENCH_RESORT_EVERY": "3"}, ["--resort-every", "3"]),
    ({"BENCH_BUCKET_CAPACITY": "12"}, ["--bucket-capacity", "12"]),
    ({"BENCH_RESOLUTION": "32"}, ["--resolution", "32"]),
    ({"BENCH_ENGINE": "stream"}, ["--engine", "stream"]),
    ({"BENCH_ENGINE": "table", "BENCH_RESOLUTION": "24",
      "BENCH_BUCKET_CAPACITY": "20", "BENCH_PASS_A": "stale",
      "BENCH_PASS_B": "sort", "BENCH_PUSHBACK": "kernel",
      "BENCH_SDF_CAPACITY": "6", "BENCH_MG_DTYPE": "f32",
      "BENCH_MIDPOINT_FACTOR": "2.25", "BENCH_GATHER_DTYPE": "bf16",
      "BENCH_SPLIT_TERMS": "1", "BENCH_RESORT_EVERY": "4"},
     ["--engine", "table", "--resolution", "24", "--bucket-capacity", "20",
      "--pass-a", "stale", "--pass-b", "sort", "--pushback", "kernel",
      "--sdf-capacity", "6", "--mg-dtype", "f32", "--midpoint-factor",
      "2.25", "--gather-dtype", "bf16", "--split-terms", "1",
      "--resort-every", "4"]),
]

# bench.py's main with initialize recorded and the run stopped (a
# BaseException, which its retry on "table" does not catch)
_JAX_RECORDER = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import flipviscosity3d_tpu

class Stop(BaseException):
    pass

calls = []

def record(self, *args, **kwargs):
    calls.append([list(args), kwargs])
    raise Stop

flipviscosity3d_tpu.FluidSimulation.initialize = record
import bench

out = []
for env in json.loads(sys.argv[1]):
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[k]
    os.environ.update(env)
    calls.clear()
    try:
        bench.main()
    except Stop:
        pass
    out.append(list(calls))
print(json.dumps(out))
"""


class _Stop(BaseException):
    pass


def test_bench_flags_give_bench_py_initialize_arguments(tmp_path,
                                                        monkeypatch):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RECORDER,
         json.dumps([e for e, _ in KNOB_CASES])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])

    calls = []

    def record(self, *args, **kwargs):
        calls.append([list(args), kwargs])
        raise _Stop

    monkeypatch.setattr(tsim.FluidSimulation, "initialize", record)
    for (env_case, flags), jax_calls in zip(KNOB_CASES, want):
        calls.clear()
        with pytest.raises(_Stop):
            main(bench.run, bench.__doc__, argv=["--device", "cpu"] + flags,
                 **bench.FLAGS)
        assert calls == jax_calls, (env_case, calls, jax_calls)
    # the default engine is BENCH_DEFAULT's in both
    with open(os.path.join(REPO, "BENCH_DEFAULT")) as f:
        assert want[0][0][1]["particle_engine"] == f.read().split()[0]


def _cli(module, args, timeout=300):
    code = ("import sys, runpy, torch; sys.modules['jax'] = None; "
            "torch.set_num_threads(1); "
            f"sys.argv = ['{module}'] + sys.argv[1:]; "
            f"runpy.run_module('flipviscosity3d_torch.scripts.{module}', "
            "run_name='__main__')")
    return subprocess.run([sys.executable, "-c", code] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_bench_prints_one_line_without_vs_baseline():
    proc = _cli("bench", ["--device", "cpu", "--resolution", "16",
                          "--frames", "1"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["unit"] == "steps/s" and line["value"] > 0
    assert line["metric"].startswith("sim substeps/sec, 16^3 grid, ")
    assert "vs_baseline" not in line and line["card"] == "cpu"
    assert line["engine"] == "pallas" and line["substeps"] >= 1
    for k in ("bucket_overflow", "pressure_iterations",
              "viscosity_iterations", "peak_bytes"):
        assert k in line
    assert "flipviscosity3d_tpu" not in proc.stderr


def test_bench_fails_with_its_engine_and_tries_no_other():
    """"pallas" needs whole 8^3 tiles: at 12^3 its substep raises, and the
    run exits non-zero without a result or a run on "table"."""
    proc = _cli("bench", ["--device", "cpu", "--resolution", "12",
                          "--frames", "1", "--engine", "pallas"])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "Traceback" in proc.stderr and "table" not in proc.stderr
    assert proc.stderr.count("# bench scene") == 1


BLITZ_STEPS = ["0", "1", "2", "3", "3a", "3b", "3c", "3e", "3f", "3d", "4"]


def test_hw_blitz_runs_every_step_and_writes_nothing():
    before = {n: os.stat(os.path.join(REPO, n)).st_mtime_ns
              for n in os.listdir(REPO)}
    proc = _cli("hw_blitz", ["--device", "cpu", "--res", "16",
                             "--frames", "1"])
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    steps = [ln for ln in lines if "step" in ln and ln["step"] != "5"]
    assert [s["step"] for s in steps] == BLITZ_STEPS
    assert all(s["ok"] for s in steps)
    for s in steps[3:9] + steps[10:]:
        assert s["result"]["check"] == "bench"
    assert steps[3 + 4]["result"]["overrides"] == {
        "pallas_gather_dtype": "bf16"}
    assert steps[-1]["result"]["engine"] == "table"
    winner = [ln for ln in lines if ln.get("step") == "5"]
    assert len(winner) == 1 and winner[0]["engine"] in ("pallas", "table")
    assert lines[-1]["check"] == "hw_blitz" and lines[-1]["ok"]
    after = {n: os.stat(os.path.join(REPO, n)).st_mtime_ns
             for n in os.listdir(REPO)}
    assert after == before


def test_hw_blitz_exits_non_zero_after_a_failed_step():
    """Step 3c given a pass A that the config refuses: the step fails, the
    steps after it still run and pass, and the blitz exits 1."""
    code = (
        "import sys, torch; sys.modules['jax'] = None; "
        "torch.set_num_threads(1); "
        "from flipviscosity3d_torch.scripts import hw_blitz, main; "
        "hw_blitz.BENCH_STEPS = tuple(s[:4] + ({'pass_a': 'bogus'},) "
        "if s[0] == '3c' else s for s in hw_blitz.BENCH_STEPS); "
        "sys.exit(main(hw_blitz.run, hw_blitz.__doc__, "
        "argv=['--device', 'cpu', '--res', '16', '--frames', '1'], "
        "res=128, frames=5))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    by_step = {ln["step"]: ln for ln in lines if "step" in ln}
    assert not by_step["3c"]["ok"] and "bogus" in by_step["3c"]["result"][
        "error"]
    assert all(by_step[s]["ok"] for s in ("3e", "3f", "3d", "4"))
    assert lines[-1]["failed"] == ["3c"] and not lines[-1]["ok"]
