"""The headline benchmark: simulation substeps per second on the bench scene
with the full pressure and viscosity pipeline.

    python -m flipviscosity3d_torch.scripts.bench [--device cpu]
        [--engine table|pallas|stream|auto] [--resolution 128] [--frames 5]
        [--bucket-capacity 16] [--pass-a sort|stale] [--pass-b plan|sort]
        [--pushback gather|kernel] [--sdf-capacity N] [--mg-dtype f32|bf16]
        [--midpoint-factor X] [--gather-dtype f32|bf16] [--split-terms N]
        [--resort-every N]

Counterpart of the JAX repo's bench.py (its BENCH_* environment knobs are
the flags, with the same defaults; a flag left out leaves the config's
default, as an unset knob does). The scene is bench_scene: a pool
filling the bottom ~27% of the box (~4.1M particles at 128^3, 8 a cell),
viscosity 5.0, gravity -9.81. One warm frame of dt = 0.01, then `frames`
timed frames; the clock stops after torch.cuda.synchronize().

The default engine is the first word of the repo's BENCH_DEFAULT file
(read, never written), "table" where there is none. "auto" runs "pallas"
and "table" for 2 frames each and then the faster one in full.

Prints one JSON line: metric, value (substeps/s), unit, and the
diagnostics bench.py prints to stderr (substeps, bucket_overflow, the last
frame's iterations), peak memory and the card. There is no vs_baseline:
bench.py's is a ratio to a target for another chip. An engine that fails
fails the run (a traceback and a non-zero exit); no other engine is
tried in its place.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from ..core.sim import FluidSimulation
from ..io.trianglemesh import box_mesh
from . import main, resolve_device, sync

DT = 0.01
BENCH_PARTICLES = 4_111_806   # the JAX bench scene's pool at 128^3
ENGINES = ("table", "pallas", "stream")
BENCH_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "BENCH_DEFAULT")
# flag -> the SimConfig field it sets (bench.py:43-64)
KNOBS = (
    ("pass_b", "pallas_pass_b"),
    ("pushback", "pallas_pushback"),
    ("sdf_capacity", "sdf_capacity"),
    ("mg_dtype", "mg_operator_dtype"),
    ("midpoint_factor", "pallas_midpoint_factor"),
    ("gather_dtype", "pallas_gather_dtype"),
    ("split_terms", "pallas_split_terms"),
    ("pass_a", "pallas_pass_a"),
    ("resort_every", "pallas_resort_every"),
)


def pool_mesh(res: int, lift: float = 0.0):
    """The bench scene's pool: a box filling the bottom ~27% of the unit
    domain, 2.5 cells off the walls, moved up by `lift`."""
    lo = 2.5 / res
    return box_mesh((lo, lo + lift, lo), (1.0 - lo, 0.285 + lift, 1.0 - lo))


def bench_scene(device, res: int, lift: float = 0.0,
                particle_engine: str = "pallas", bucket_capacity: int = 16,
                **overrides) -> FluidSimulation:
    """bench.py's scene (bench.py:35-100) at res^3, the pool's box moved up
    by `lift`, on `particle_engine` (bench.py's, "pallas", unless named),
    with config `overrides`."""
    sim = FluidSimulation(device)
    sim.initialize(res, res, res, 1.0 / res, bucket_capacity=bucket_capacity,
                   particle_engine=particle_engine, **overrides)
    sim.add_liquid(pool_mesh(res, lift))
    sim.set_viscosity(5.0)
    sim.set_gravity(0.0, -9.81, 0.0)
    return sim


def default_engine(path: str = BENCH_DEFAULT) -> str:
    """The engine BENCH_DEFAULT names (bench.py:133-141), else "table"."""
    if os.path.exists(path):
        with open(path) as f:
            words = f.read().split()
        if words and words[0] in ENGINES + ("auto",):
            return words[0]
    return "table"


def overrides(**knobs) -> dict:
    """The config overrides of the knob flags that are set (not None)."""
    return {field: knobs[flag] for flag, field in KNOBS
            if knobs.get(flag) is not None}


def run_engine(dev, engine: str, resolution: int, frames: int,
               bucket_capacity: int, log=print, **knobs) -> dict:
    """One bench run on `engine` -> its line (without the card)."""
    sim = bench_scene(dev, resolution, particle_engine=engine,
                      bucket_capacity=bucket_capacity, **overrides(**knobs))
    n = int(sim.state.pos.shape[0])
    log(f"# bench scene: {resolution}^3 grid, {n} particles")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sim.advance(DT)
    log("# first frame done")
    sync(dev)
    substeps = overflow = 0
    t0 = time.perf_counter()
    for _ in range(frames):
        diag = sim.advance(DT)
        substeps += diag.substeps
        overflow += diag.bucket_overflow
    sync(dev)
    wall = time.perf_counter() - t0
    log(f"# engine={engine} substeps={substeps} bucket_overflow={overflow} "
        f"last-frame iters: pressure={diag.pressure_iterations} "
        f"viscosity={diag.viscosity_iterations}")
    return {
        "metric": f"sim substeps/sec, {resolution}^3 grid, {n} particles, "
                  "full pressure+viscosity",
        "value": substeps / wall,
        "unit": "steps/s",
        "engine": engine,
        "overrides": overrides(**knobs),
        "bucket_capacity": bucket_capacity,
        "particles": n,
        "frames": frames,
        "substeps": substeps,
        "wall_s": wall,
        "bucket_overflow": overflow,
        "pressure_iterations": diag.pressure_iterations,
        "viscosity_iterations": diag.viscosity_iterations,
        "pressure_residual": diag.pressure_residual,
        "viscosity_residual": diag.viscosity_residual,
        "peak_bytes": (torch.cuda.max_memory_allocated()
                       if dev.type == "cuda" else None),
    }


def run(device="cuda", engine=None, resolution: int = 128, frames: int = 5,
        bucket_capacity: int = 16, log=None, **knobs) -> dict:
    """bench.py's main on `engine` (default_engine() when None) -> its line
    (the check name "bench" and "ok" added). Raises where the engine
    does."""
    dev = resolve_device(device)
    if log is None:
        log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731,E501
    engine = engine or default_engine()
    args = dict(resolution=resolution, bucket_capacity=bucket_capacity,
                log=log, **knobs)
    scores = None
    if engine == "auto":
        scores = {}
        for eng in ("pallas", "table"):
            scores[eng] = run_engine(dev, eng, frames=2, **args)["value"]
            log(f"# auto: {eng} {scores[eng]} steps/s")
        engine = max(scores, key=scores.get)
        log(f"# auto: running full bench on {engine!r}")
    line = run_engine(dev, engine, frames=frames, **args)
    if scores is not None:
        line["auto"] = scores
    return {"check": "bench", **line, "ok": True}


# the command line's flags and their defaults (scripts.main)
FLAGS = dict(engine=(str, None), resolution=128, frames=5,
             bucket_capacity=16, pass_a=(str, None), pass_b=(str, None),
             pushback=(str, None), sdf_capacity=(int, None),
             mg_dtype=(str, None), midpoint_factor=(float, None),
             gather_dtype=(str, None), split_terms=(int, None),
             resort_every=(int, None))


if __name__ == "__main__":
    sys.exit(main(run, __doc__, **FLAGS))
