"""Kernel-vs-plain tests of the port that need a CUDA device.

Marked `gpu`; they skip (from a fixture) where torch sees no CUDA device.
This file imports no JAX, so it also runs on a machine without it:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.ops import pallas_mg as pm
from flipviscosity3d_torch.ops import pallas_particles as pp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_versions(cuda):
    sim = smoke.bench_scene(cuda, 32)
    records = smoke.check_kernels(sim.state, sim.cfg)
    assert [r["name"] for r in records] == [
        "scatter_p2g_table", "gather_mac", "mg_down", "mg_up"]
    for r in records:
        assert r["ok"], r


@pytest.mark.gpu
def test_main_path_launches_every_kernel(cuda):
    result = smoke.run_main_path(cuda, 32, 1)
    assert result["failures"] == []
    assert all(c > 0 for c in result["launches"].values())


@pytest.mark.gpu
def test_profile_frames_sees_device_time(cuda):
    prof = smoke.profile_frames(32, 1, top=1000)
    assert prof["substeps"] >= 1
    assert 0 < prof["device_busy_ms"] <= prof["wall_ms"]
    assert any("mg_down_kernel" in e["name"] for e in prof["top"])


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    b = torch.zeros((1, 8, 8, 8), device=cuda)
    links = (b, b, b)
    with pytest.raises(ValueError):
        pm.mg_down(b.double(), links, b.double(), 0.8)
    with pytest.raises(ValueError):
        pm.mg_down(b, links, b.transpose(1, 2), 0.8)
    pos = torch.zeros((4, 3), device=cuda)
    key = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        pp.scatter_p2g_table(pos, pos, key, key, (8, 8, 8), 1 / 8, 4)
