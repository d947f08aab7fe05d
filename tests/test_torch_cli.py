"""The port's scene CLI against the JAX package's, on the CPU, at 16^3.

A 16^3 state is saved once by the JAX package's save_state. Both CLIs then
resume from that file, on mesh files written from io/primitives, under one
scene file whose config block names the engine both run ("pallas"), and
bake two frames. Seeding differs between the packages (jax.random against a
torch.Generator), which is why both resume from one state.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.core.state import SimState as JaxState
from flipviscosity3d_tpu.core.state import SolidBoundary as JaxSolid
from flipviscosity3d_tpu.utils import checkpoint as jckpt
from flipviscosity3d_torch import cli, smoke
from flipviscosity3d_torch.core.sim import FluidSimulation
from flipviscosity3d_torch.core.state import state_to_numpy
from flipviscosity3d_torch.io import primitives
from flipviscosity3d_torch.io import trianglemesh as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTAINER = ((0.5, 0.5, 0.5), 0.8)
DROP = ((0.5, 0.55, 0.5), 0.2)
INT_FIELDS = ("substeps", "pressure_iters", "viscosity_iters",
              "liquid_cells", "bucket_overflow")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def scene(tmp_path):
    """Mesh files from io/primitives and one scene file for both CLIs."""
    box, drop = str(tmp_path / "box.ply"), str(tmp_path / "drop.ply")
    tm.save_ply(box, primitives.cube(*CONTAINER))
    tm.save_ply(drop, primitives.sphere(*DROP))
    path = str(tmp_path / "scene.json")
    with open(path, "w") as f:
        json.dump({"resolution": 16, "frames": 2, "viscosity": 2.0,
                   "boundary_mesh": box, "liquid_meshes": [drop],
                   "export": "ply",
                   "config": {"particle_engine": "pallas",
                              "bucket_capacity": 16}}, f)
    return path


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_both_clis_bake_the_same_two_frames(scene, tmp_path, monkeypatch):
    """Both CLIs, resumed from one state saved by the JAX package, print
    JSON lines with the same keys that agree exactly in substeps,
    pressure_iters, viscosity_iters, liquid_cells and bucket_overflow and to
    1e-4 relative in max_velocity; the exported last frame (the particles
    after the first frame) agrees to 1e-5."""
    run = _bake_both(scene, tmp_path, monkeypatch)
    assert run.sim.cfg.particle_engine == "pallas"


def test_a_scene_without_an_engine_bakes_the_same_frames_in_both(
        scene, tmp_path, monkeypatch):
    """The scene file's config names no particle_engine: both CLIs run
    their default, the JAX package's "table" engine, and bake the same two
    frames (as test_both_clis_bake_the_same_two_frames holds them)."""
    with open(scene) as f:
        spec = json.load(f)
    del spec["config"]["particle_engine"]
    with open(scene, "w") as f:
        json.dump(spec, f)
    run = _bake_both(scene, tmp_path, monkeypatch)
    assert run.sim.cfg.particle_engine == "table"


def _bake_both(scene, tmp_path, monkeypatch):
    """Both CLIs bake `scene`'s two frames from one state saved by the JAX
    package; their lines and exports are held equal -> the port's
    SceneRun."""
    sim = FluidSimulation("cpu")
    sim.initialize(16, 16, 16, 1.0 / 16, bucket_capacity=16)
    sim.add_boundary(primitives.cube(*CONTAINER), inverted=True)
    sim.add_liquid(primitives.sphere(*DROP))
    sim.set_viscosity(2.0)
    arrays = state_to_numpy(sim.state)
    rng = np.random.default_rng(0)
    arrays["vel"] = rng.normal(scale=0.3, size=arrays["vel"].shape).astype(
        np.float32)
    solid = JaxSolid(**{k: jnp.asarray(arrays[k]) for k in JaxSolid._fields})
    ckpt = str(tmp_path / "start.npz")
    jckpt.save_state(ckpt, JaxState(solid=solid, **{
        k: jnp.asarray(arrays[k]) for k in JaxState._fields
        if k != "solid"}))

    # the JAX CLI configures a compilation cache when it is imported
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    from flipviscosity3d_tpu import cli as jcli

    out_j, out_t = str(tmp_path / "out_jax"), str(tmp_path / "out_port")
    monkeypatch.setattr(sys, "argv", [
        "run_scene", "--scene", scene, "--resume", ckpt, "--output-dir",
        out_j])
    buf = io.StringIO()
    with redirect_stdout(buf):
        jcli.main()
    jlines = _lines(buf.getvalue())
    run, tlines, _ = smoke.run_cli([
        "--scene", scene, "--resume", ckpt, "--output-dir", out_t,
        "--device", "cpu"])

    assert len(jlines) == len(tlines) == 2
    for j, t in zip(jlines, tlines):
        assert list(j) == list(t)
        for k in INT_FIELDS:
            assert j[k] == t[k], k
        assert t["max_velocity"] == pytest.approx(j["max_velocity"],
                                                  rel=1e-4)
        assert t["pressure_iters"] > 0 and t["viscosity_iters"] > 0
    for name in ("0000.ply", "0001.ply"):
        pj = tm.load_ply(os.path.join(out_j, name)).vertices
        pt = tm.load_ply(os.path.join(out_t, name)).vertices
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        tm.load_ply(os.path.join(out_t, "0000.ply")).vertices, arrays["pos"])
    assert len(run.frames) == 2
    return run


def test_cli_takes_a_scene_with_the_gather_dtype(scene, tmp_path):
    """A scene file whose config block sets pallas_gather_dtype, as the JAX
    CLI takes it, runs under the port's CLI and reaches its config; a value
    outside "f32" / "bf16" is refused before anything is baked."""
    with open(scene) as f:
        spec = json.load(f)
    out = tmp_path / "out"
    for value in ("bf16", "f16"):
        spec["config"]["pallas_gather_dtype"] = value
        path = str(tmp_path / f"scene_{value}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        argv = ["--scene", path, "--device", "cpu", "--frames", "1",
                "--export", "none", "--output-dir", str(out)]
        if value == "f16":
            with pytest.raises(ValueError, match="pallas_gather_dtype"):
                cli.main(argv)
        else:
            run = cli.main(argv)
            assert run.sim.cfg.pallas_gather_dtype == "bf16"
            assert len(run.frames) == 1
            assert run.frames[0].pressure_iterations > 0


def test_both_clis_take_a_scene_with_the_mg_backend_and_split_terms(
        scene, tmp_path, monkeypatch):
    """A scene file whose config block sets mg_backend "xla" and
    pallas_split_terms 2 (the JAX package's two-term split of the particle
    kernels' products, which the port rounds the same way) bakes the same
    two frames under both CLIs, held as
    test_both_clis_bake_the_same_two_frames holds them."""
    with open(scene) as f:
        spec = json.load(f)
    spec["config"].update(mg_backend="xla", pallas_split_terms=2)
    with open(scene, "w") as f:
        json.dump(spec, f)
    run = _bake_both(scene, tmp_path, monkeypatch)
    assert run.sim.cfg.mg_backend == "xla"
    assert run.sim.cfg.pallas_split_terms == 2


def test_scene_file_yields_to_explicit_flags(scene):
    """Scene keys fill in the flags left at their defaults; a flag given on
    the command line wins; config, liquid_meshes and invert_boundary stay in
    scene_spec (the JAX CLI's rule, flipviscosity3d_tpu/cli.py:70-80)."""
    args = cli.parse_args(["--scene", scene])
    assert (args.resolution, args.frames, args.viscosity) == (16, 2, 2.0)
    assert args.export == "ply" and args.dt == 0.01
    assert args.device == "cuda"
    assert args.scene_spec["config"]["particle_engine"] == "pallas"
    assert not hasattr(args, "liquid_meshes")
    args = cli.parse_args(["--scene", scene, "--frames", "7", "--export",
                           "none", "--device", "cpu", "--viscosity", "0.5"])
    assert (args.frames, args.export, args.viscosity) == (7, "none", 0.5)
    assert args.resolution == 16 and args.device == "cpu"
    bare = cli.parse_args([])
    assert (bare.resolution, bare.frames, bare.export) == (64, 300, "obj")
    assert bare.scene_spec == {} and bare.checkpoint_every == 0


def test_cli_flags_are_the_jax_cli_s(monkeypatch):
    """Every flag of the JAX CLI is a flag of the port's, with the same
    default (mesh paths apart, which name sample meshes outside the
    repository); the port adds --device."""
    from flipviscosity3d_tpu import cli as jcli

    monkeypatch.setattr(sys, "argv", ["run_scene"])
    jflags, tflags = vars(jcli.parse_args()), vars(cli.parse_args([]))
    assert set(tflags) - set(jflags) == {"device"}
    assert set(jflags) <= set(tflags)
    for k, v in jflags.items():
        if k not in ("boundary_mesh", "liquid_mesh"):
            assert tflags[k] == v, k


def test_cli_without_a_card_fails_unless_asked_for_the_cpu(scene, tmp_path):
    """The default device is the card: without one main() raises before it
    bakes anything, and never runs on the CPU by itself."""
    argv = ["--scene", scene, "--output-dir", str(tmp_path / "out")]
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "out" / "0000.ply")


def test_cli_profile_dir_traces_frames_2_to_4(scene, tmp_path):
    """--profile-dir writes one torch.profiler chrome trace, started before
    frame 2 and stopped before frame 5, which holds the program's own spans
    of those frames (utils/trace.py): their substeps and CG iterations."""
    prof = tmp_path / "prof"
    run = cli.main(["--scene", scene, "--device", "cpu", "--frames", "6",
                    "--export", "none", "--profile-dir", str(prof),
                    "--output-dir", str(tmp_path / "out")])
    assert len(run.frames) == 6
    trace = prof / "frames_2_4.json"
    assert trace.exists() and trace.stat().st_size > 1000
    data = json.loads(trace.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert spans.count("advance") == 3
    assert spans.count("substep") == sum(d.substeps for d in run.frames[2:5])
    assert "pcg.apply_A" in spans


def test_cli64_path_resumes_on_cpu(tmp_path):
    """chip_smoke.py's cli64 path at 16^3 on the CPU: exports read back,
    the resumed run repeats the first run's frames 2 and 3 in every integer
    field and ends bit-equal (CPU tensors, fixed summation order)."""
    result = smoke.run_cli64("cpu", tmp_path, resolution=16)
    assert result["failures"] == []
    assert result["timed_frames"] == 6 and result["substeps"] >= 6
    assert result["obj_max_abs_err"] <= 1e-6
    assert result["resumed_final_max_abs_diff"] == 0.0
    for name in ("0003.obj", "0003.ply", "ckpt_0002.npz"):
        assert (tmp_path / "cli64" / name).exists()
    assert not (tmp_path / "cli64" / "ckpt_0001.npz").exists()


def test_cli_runs_as_a_module_without_jax(tmp_path):
    """python -m flipviscosity3d_torch.cli parses its flags in a process
    where jax cannot be imported."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.argv = ['flipviscosity3d_torch.cli', '--help']; "
            "runpy.run_module('flipviscosity3d_torch.cli', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--resume" in proc.stdout
