"""The port's revisit probes and hardware-check modules, on the CPU.

The plain versions of the two probe kernels are held against the numpy
oracles of the JAX package's scripts/gather_perf_probe.py (np.add.at into
zeros; fancy indexing), on seeded inputs. That script builds its Pallas
calls for the TPU only (no interpret mode), so it is not imported here:
the oracles are its lines 171-175 and 187-189, written out from the script
as of commit a3eabe7 (git blob 4f39336): a later edit of that script wants
them read again. Each module of
flipviscosity3d_torch.scripts then runs at a small size with --device cpu,
where the wrappers take the plain versions.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.ops import pallas_particles as pp
from flipviscosity3d_torch.scripts import gather_perf_probe as probe
from flipviscosity3d_torch.scripts import gather_smem_check, pallas_hw_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, W = pp.C, pp.W


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _quiet(line):
    pass


def _sorted_keys(n, n_tiles, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, n_tiles * W // 3, n)).astype(np.int32)


CASES = [(1300, 128), (512, 24), (7, 5), (513, 128), (2048, 3), (1, 128)]


@pytest.mark.parametrize("n,f", CASES)
def test_scatter_revisit_ref_matches_the_numpy_oracle(n, f):
    """np.add.at adds in stream order, as index_add_ does on the CPU: rtol
    1e-6 / atol 1e-6; untouched cells are exactly zero."""
    n_tiles = 8
    key = _sorted_keys(n, n_tiles, 1)
    rng = np.random.default_rng(2)
    n_chunks = -(-n // C)
    vals = rng.standard_normal((n_chunks, C, f)).astype(np.float32)
    ref = np.zeros((n_tiles, W, f), np.float32)
    np.add.at(ref, (key // W, key % W), vals.reshape(-1, f)[:n])
    got = probe.scatter_revisit(torch.from_numpy(key),
                                torch.from_numpy(vals), n_tiles)
    assert tuple(got.shape) == (n_tiles, W, f)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    touched = np.zeros(n_tiles * W, bool)
    touched[key] = True
    assert not got.reshape(-1, f)[torch.from_numpy(~touched)].any()
    assert probe.scatter_revisit.launches == 0


@pytest.mark.parametrize("n,f", CASES)
def test_gather_revisit_ref_matches_the_numpy_oracle(n, f):
    """Exact; rows past N are zero."""
    n_tiles = 8
    key = _sorted_keys(n, n_tiles, 3)
    cols = np.random.default_rng(4).standard_normal(
        (n_tiles, W, f)).astype(np.float32)
    n_chunks = -(-n // C)
    ref = np.zeros((n_chunks * C, f), np.float32)
    ref[:n] = cols[key // W, key % W]
    got = probe.gather_revisit(torch.from_numpy(key), torch.from_numpy(cols))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert probe.gather_revisit.launches == 0


def test_pallas_hw_check_passes_on_cpu_and_bites():
    """The gate at 16^3: every check passes; handed an image that differs
    from the one its oracle reads, in one value, it fails, and only the
    gather checks do."""
    result = pallas_hw_check.run("cpu", res=16, log=_quiet)
    assert result["ok"] and len(result["checks"]) == 5
    assert result["particles"] == 2 * 16 ** 3

    def one_value(cols):
        bad = cols.clone()
        bad.view(-1)[::97] += 1.0
        return bad

    broken = pallas_hw_check.run("cpu", res=16, tamper=one_value, log=_quiet)
    assert not broken["ok"]
    assert [c["ok"] for c in broken["checks"]] == [True, True, True, False,
                                                  False]


def test_gather_smem_check_passes_on_cpu():
    result = gather_smem_check.run("cpu", res=16, n=5000, batch_ms=1.0,
                                   log=_quiet)
    assert result["ok"]
    assert [c["n_cols"] for c in result["checks"]] == [108, 54]


def test_gather_perf_probe_passes_on_cpu():
    result = probe.run("cpu", res=16, n=3000, bench_n=6000, batch_ms=1.0,
                       log=_quiet)
    assert result["ok"] and [c["n"] for c in result["checks"]] == [3000, 6000]
    assert all(c["scatter_repeatable"] and c["gather_ok"]
               for c in result["checks"])


def test_hw_check_path_runs_on_cpu():
    """chip_smoke.py's hw_check path at small sizes on CPU tensors: the four
    module runs pass; no kernel launches are counted (and none is asked
    for, off the card)."""
    result = smoke.run_hw_check("cpu", 16, 5000, 16, 3000, log=_quiet)
    assert result["failures"] == []
    assert [m["check"] for m in result["modules"]] == [
        "pallas_hw_check", "gather_smem_check", "gather_smem_check",
        "gather_perf_probe"]
    assert result["path_kernels"] == ["gather_rows", "detile",
                                      "scatter_revisit", "gather_revisit"]
    assert all(result["launches"][k] == 0 for k in result["path_kernels"])


@pytest.mark.parametrize("module,flags", [
    ("pallas_hw_check", ["--res", "16"]),
    ("gather_smem_check", ["--res", "16", "--n", "4000"]),
    ("gather_perf_probe", ["--res", "16", "--n", "2000", "--bench-n",
                           "3000"]),
])
def test_check_modules_run_from_the_command_line_without_jax(module, flags):
    """python -m flipviscosity3d_torch.scripts.<name> --device cpu exits 0
    in a process where jax cannot be imported, and its last line is the
    result as JSON; without --device it asks for the card and fails here."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            f"sys.argv = ['{module}'] + {flags!r} + sys.argv[1:]; "
            f"runpy.run_module('flipviscosity3d_torch.scripts.{module}', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code, "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["check"] == module and last["card"] == "cpu"
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
