"""The output check against the plain reference: it agrees with the port on
the CPU, and a run comes out not correct under the control (the port's own
bf16 path) and under each fault a cell can have, planted in the timed
path underneath the harness. The card test runs a real cell.

One card holds each cell, so a cell has no exchange between chips to leave
out; the faults are a step that returns its state unchanged, half of the
particles left out, and one particle's position altered where the step
produces it."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import flipviscosity3d_torch.core.step as step_mod
from benchmark.tests.test_bench_harness import (ROOT, _one_thread,  # noqa
                                                make_checkout, run_cell)


def test_reference_agrees_with_the_port_on_the_cpu(tmp_path, capsys):
    line = run_cell(capsys, make_checkout(tmp_path), seed=2 ** 31 + 77)
    assert line["correct"] is True
    # both sides run the plain kernels in the same order on the CPU
    assert all(c["value"] == 0.0 for c in line["checks"].values())


@pytest.mark.parametrize("cell", ["tiny16.visc5", "tiny16.inviscid"])
def test_control_is_not_correct(tmp_path, capsys, cell):
    line = run_cell(capsys, make_checkout(tmp_path), cell=cell,
                    extra=("--control", "1"))
    assert line["correct"] is False
    failed = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed


def _faulty(fault):
    real = step_mod.step

    def step(state, dt, cfg, substep_idx=None):
        new, d = real(state, dt, cfg, substep_idx=substep_idx)
        if fault == "unchanged":
            return state, d
        if fault == "half_left_out":
            n = new.pos.shape[0] // 2
            return new.replace(pos=new.pos[:n], vel=new.vel[:n]), d
        pos = new.pos.clone()
        pos[pos.shape[0] // 2, 1] += cfg.dx
        return new.replace(pos=pos), d

    return step


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_fault_in_the_timed_path_is_not_correct(tmp_path, capsys,
                                                 monkeypatch, fault):
    monkeypatch.setattr(step_mod, "step", _faulty(fault))
    line = run_cell(capsys, make_checkout(tmp_path))
    assert line["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace_on", [0, 1])
def test_cell_on_the_card(card, trace_on):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pool128.visc5",
         "--seed", "4100000003", "--seconds", "5", "--trace",
         str(trace_on)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env={**os.environ})
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
