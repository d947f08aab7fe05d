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
        "scatter_p2g_table", "gather_mac", "mg_down", "mg_up",
        "scatter_p2g_table_stale", "gather_rows8",
        "scatter_p2g_table_folded", "scatter_p2g_table_stale_folded"]
    for r in records:
        assert r["ok"], r
        assert r["bound_by"] in ("bytes", "operations")
        assert 0 < r["bound_ms"] and 0 < r["ms"]


@pytest.mark.gpu
def test_main_path_launches_every_kernel(cuda, tmp_path, monkeypatch):
    """The three main paths at 32^3 launch the six unfolded kernels; the
    CLI's paths with the large-grid threshold lowered to 32^3
    launch the two folded ones."""
    launched = set()
    for _, dt, lift, overrides in smoke.MAIN_PATHS:
        result = smoke.run_main_path(cuda, 32, 1, dt=dt, lift=lift,
                                     **overrides)
        assert result["failures"] == []
        launched |= {k for k, c in result["launches"].items() if c > 0}
    assert launched == {fn.__name__ for fn, _, _ in smoke.KERNELS[:6]}
    monkeypatch.setattr(pp, "FOLD_CELLS", 32 ** 3)
    for name, dt, lift, overrides in smoke.MAIN_PATHS[:2]:
        result = smoke.run_scene_path(cuda, tmp_path, name, 32, 1, dt=dt,
                                      lift=lift, **overrides)
        assert result["failures"] == []
        launched |= {k for k, c in result["launches"].items() if c > 0}
    assert launched == {fn.__name__ for fn, _, _ in smoke.KERNELS}


@pytest.mark.gpu
def test_cli64_resumes_on_the_card(cuda, tmp_path):
    result = smoke.run_cli64(cuda, tmp_path, resolution=32)
    assert result["failures"] == []
    assert result["resumed_final_max_abs_diff"] <= 1e-5


@pytest.mark.gpu
def test_folded_kernels_match_unfolded_where_they_fold_by_themselves(
        cuda, monkeypatch):
    """check_kernels as the smoke run calls it at 256^3: on a grid that
    folds by itself, the plain scatters in runs of particles."""
    monkeypatch.setattr(pp, "FOLD_CELLS", 32 ** 3)
    sim = smoke.bench_scene(cuda, 32)
    assert pp.large_grid(sim.cfg.grid_shape)
    for r in smoke.check_kernels(sim.state, sim.cfg, ref_slabs=16):
        assert r["ok"], r


@pytest.mark.gpu
def test_fluid_simulation_defaults_to_the_card(cuda):
    from flipviscosity3d_torch import FluidSimulation
    assert FluidSimulation().device.type == "cuda"


@pytest.mark.gpu
def test_profile_frames_sees_device_time(cuda):
    prof = smoke.profile_frames(32, 1, top=1000)
    assert prof["substeps"] >= 1
    assert 0 < prof["device_busy_ms"] <= prof["wall_ms"]
    assert any("mg_down_kernel" in e["name"] for e in prof["top"])
    sim = smoke.bench_scene(cuda, 32)
    assert smoke.profile_sim(sim, 1)["device_busy_ms"] > 0


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
    plan = pp.plan_pass_a(key.int(), (8, 8, 8))
    with pytest.raises(ValueError):
        pp.scatter_p2g_table_stale(pos, pos, key, plan, (8, 8, 8), 1 / 8, 4)
    with pytest.raises(ValueError):
        pp.gather_rows8(key.int(), plan.covered.int(),
                        torch.zeros((9, 9, 9), device=cuda), (8, 8, 8))
