"""Scene CLI of the port.

    python -m flipviscosity3d_torch.cli --scene scene.json [--device cpu]

The reference's main.cpp (main.cpp:42-90) as a configurable command, with
the flags, scene-file keys and per-frame JSON line of
flipviscosity3d_tpu/cli.py: a boundary mesh (a container unless
--no-invert-boundary), one or more liquid meshes, per-frame OBJ/PLY particle
export, exact-resume checkpoints. `--device` is the port's own flag: "cuda"
(the default; without a card the run fails) or "cpu".

The default mesh paths name the reference's sample meshes, which are not
part of this repository: pass --boundary-mesh / --liquid-mesh or a scene
file. io/primitives.py makes stand-ins:

    from flipviscosity3d_torch.io import primitives, trianglemesh
    trianglemesh.save_ply("drop.ply", primitives.sphere((.5, .6, .5), .2))
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from . import FluidSimulation, StepDiagnostics
from .io import trianglemesh as tm
from .utils.checkpoint import load_state, save_state

SAMPLE_MESHES = "sample_meshes"


@dataclasses.dataclass
class SceneRun:
    """What main() hands an in-process caller: the simulation in its final
    state, and each frame's diagnostics (the printed lines hold a part)."""

    sim: FluidSimulation
    frames: list[StepDiagnostics]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--resolution", type=int, default=64)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--viscosity", type=float, default=5.0)
    p.add_argument("--gravity", type=float, nargs=3, default=(0.0, -9.81, 0.0))
    p.add_argument(
        "--boundary-mesh", default=f"{SAMPLE_MESHES}/sphere_large.ply"
    )
    p.add_argument("--no-invert-boundary", action="store_true",
                   help="treat the boundary mesh as a solid, not a container")
    p.add_argument("--liquid-mesh", default=f"{SAMPLE_MESHES}/stanford_bunny.ply")
    p.add_argument("--output-dir", default="bakefiles")
    p.add_argument("--export", choices=("obj", "ply", "both", "none"),
                   default="obj")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save an exact-resume npz every N frames")
    p.add_argument("--resume", default=None,
                   help="restore SimState from a checkpoint npz (of this "
                        "package or of flipviscosity3d_tpu)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of frames 2-4")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the simulation runs; cuda fails without a card")
    p.add_argument("--scene", default=None,
                   help="JSON scene spec; keys mirror the CLI flags "
                        "(resolution, frames, dt, viscosity, gravity, "
                        "boundary_mesh, invert_boundary, liquid_meshes, "
                        "output_dir, export) plus SimConfig overrides under "
                        "'config'")
    args = p.parse_args(argv)
    if args.scene:
        with open(args.scene) as f:
            spec = json.load(f)
        defaults = {a.dest: a.default for a in p._actions}
        for key, val in spec.items():
            if key in ("config", "liquid_meshes", "invert_boundary"):
                continue
            # explicit command-line flags win over the scene file
            if getattr(args, key, None) == defaults.get(key):
                setattr(args, key, val)
        args.scene_spec = spec
    else:
        args.scene_spec = {}
    return args


def export_particles(frame, positions, outdir, fmt):
    mesh = tm.TriangleMesh(vertices=np.asarray(positions, np.float32))
    name = f"{frame:04d}"
    if fmt in ("obj", "both"):
        tm.save_obj(os.path.join(outdir, name + ".obj"), mesh)
    if fmt in ("ply", "both"):
        tm.save_ply(os.path.join(outdir, name + ".ply"), mesh)


def _start_trace(profile_dir):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, profile_dir):
    prof.stop()
    prof.export_chrome_trace(os.path.join(profile_dir, "frames_2_4.json"))


def main(argv=None) -> SceneRun:
    """Run a scene; `argv` None reads sys.argv."""
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    t_setup = time.perf_counter()
    n = args.resolution
    dx = 1.0 / n
    sim = FluidSimulation(args.device)
    sim.initialize(n, n, n, dx, **args.scene_spec.get("config", {}))

    boundary = tm.load_ply(args.boundary_mesh)
    inverted = args.scene_spec.get(
        "invert_boundary", not args.no_invert_boundary
    )
    sim.add_boundary(boundary, inverted=inverted)

    for mesh_path in args.scene_spec.get("liquid_meshes", [args.liquid_mesh]):
        sim.add_liquid(tm.load_ply(mesh_path))

    sim.set_viscosity(args.viscosity)
    sim.set_gravity(*args.gravity)

    if args.resume:
        sim._state = load_state(args.resume, sim.device)

    n_particles = sim.state.pos.shape[0]
    _sync(sim.device)
    print(f"initialized: {n}^3 grid, {n_particles} particles, "
          f"{time.perf_counter() - t_setup:.1f} s", flush=True)

    prof = None
    frames = []
    try:
        for frame in range(args.frames):
            if args.export != "none":
                export_particles(
                    frame, sim.particle_positions, args.output_dir, args.export
                )
            if (args.checkpoint_every and frame
                    and frame % args.checkpoint_every == 0):
                save_state(
                    os.path.join(args.output_dir, f"ckpt_{frame:04d}.npz"),
                    sim.state,
                )
            if args.profile_dir and frame == 2:
                prof = _start_trace(args.profile_dir)
            if prof is not None and frame == 5:
                _stop_trace(prof, args.profile_dir)
                prof = None
            _sync(sim.device)
            t0 = time.perf_counter()
            diag = sim.advance(args.dt)
            _sync(sim.device)
            wall = time.perf_counter() - t0
            frames.append(diag)
            print(
                json.dumps(
                    dict(
                        frame=frame,
                        wall_s=round(wall, 4),
                        substeps=int(diag.substeps),
                        pressure_iters=int(diag.pressure_iterations),
                        pressure_residual=float(diag.pressure_residual),
                        viscosity_iters=int(diag.viscosity_iterations),
                        viscosity_residual=float(diag.viscosity_residual),
                        max_velocity=round(float(diag.max_velocity), 4),
                        liquid_cells=int(diag.liquid_cells),
                        bucket_overflow=int(diag.bucket_overflow),
                    )
                ),
                flush=True,
            )
    finally:
        if prof is not None:
            _stop_trace(prof, args.profile_dir)
    return SceneRun(sim, frames)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


if __name__ == "__main__":
    main()
