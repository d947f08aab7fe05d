"""The bench scene, the main paths, the CLI's paths and the
kernel-vs-plain checks.

`run_main_path(device, res, frames, dt, lift, **overrides)` builds the
scene that bench.py runs (a pool filling the bottom ~27% of the box,
viscosity 5, gravity -9.81), lifted by `lift` in y, through
FluidSimulation with the config `overrides`, runs one warm frame and
`frames` timed frames of `dt`, and reports diagnostics, throughput, peak
memory, the kernels' launch counts and the failed checks.
`check_kernels(state, cfg)` holds each CUDA kernel against its plain
PyTorch version on the same inputs, times both and the one PyTorch call
that computes the same function where there is one, and states each
kernel's bound. chip_smoke.py runs both at 128^3 on the card; the CPU tests
run the main paths at 16^3. `profile_frames(res, frames)` traces frames of
the scene on the card with torch.profiler (where the time goes);
`profile_sim` does so for a simulation that is already set up.

The tile-major column path (K7 gather_rows, K8 detile, the revisit probes
K9 and K10) is not on `advance`'s path, which gathers fused. Its entry
points are the hardware checks of flipviscosity3d_torch/scripts:
`run_hw_check` calls the three in turn and reads the launch counts.
`check_unfused_route` ties the slice to the main path: on a state after a
frame, build_mac_columns -> K7 -> combine_mac_samples against K2.
`run_gather_dtype_path` runs the bench path under pallas_gather_dtype
"bf16" and holds its final state apart from the f32 run's.

The "table" and "stream" engines (ENGINE_PATHS) run the bench scene
through run_main_path too; their substeps launch no particle kernel, only
the V-cycle's. `run_proto` runs the round-1 prototype module
(scripts/pallas_particle_proto.py: K11 tile_scatter, K12 tile_gather) as
its command line does and reads the launch counts; `check_kernels` holds
K11 and K12 against their plain versions on make_scene's pool at the
grid's size (at >= 2^24 cells over its first PROBE_RUN particles).

`run_scene_path` drives the same scene through the scene CLI
(cli.main) from mesh files and a scene file that it writes, as a user
would: chip_smoke.py runs it at 256^3, where the scatters fold their sums
(the "_folded" kernel records) and the face combine runs in slabs, and
then runs `check_kernels` again on that run's final state, so that every
kernel is held against its plain version at the 256^3 shapes too (the
plain scatters in slabs of particles, to fit the card). `run_cli64`
drives the CLI at its default resolution with exports, checkpoints and a
resumed second run.

`run_stream_repeat` runs the "stream" engine twice from one state (and
the slab pipeline's "stream" path twice), which must give equal bits, with
the sums' earlier index_add_ form timed beside it; `run_placed_path` holds
advance_placed (parallel/sharding.py) against the single-device advance;
`run_dryrun` runs graft_entry's dry run and entry().

`run_sharded_path` drives the slab pipeline (parallel/shard_step.py) on
the bench scene in slabs, on a LocalGroup of rank-threads, and holds its
warm frame against the single-device advance from the same state;
`run_sharded_dist` runs one frame on a DistGroup of world size 1 against a
LocalGroup of one rank; `profile_sharded` traces sharded frames.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import cli
from .config import SimConfig
from .core.sim import FluidSimulation
from .core.step import _clamp_bounds
from .io import primitives
from .io import trianglemesh as tm
from .io.trianglemesh import box_mesh
from .ops import pallas_mg as pm
from .ops import pallas_particles as pp
from .scripts import gather_perf_probe as probe
from .scripts import gather_smem_check, pallas_hw_check, time_ms
from .scripts import mg_pallas_bench, mg_profile, pallas_engine_probe
from .scripts import pallas_particle_proto as proto
from .scripts import (
    particle_microbench,
    precond_experiment,
    profile_substep,
    readiness256,
    readiness512,
    solver_microbench,
)
from .solvers import multigrid as mg
from .solvers import viscosity as vsolver
from .utils import trace

# (wrapper, source, the TPU kernel it replaces)
KERNELS = (
    (pp.scatter_p2g_table, "flipviscosity3d_torch/csrc/p2g_scatter.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:714"),
    (pp.gather_mac, "flipviscosity3d_torch/csrc/gather_mac.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:1172"),
    (pm.mg_down, "flipviscosity3d_torch/csrc/mg_vcycle.cu",
     "flipviscosity3d_tpu/ops/pallas_mg.py:245"),
    (pm.mg_up, "flipviscosity3d_torch/csrc/mg_vcycle.cu",
     "flipviscosity3d_tpu/ops/pallas_mg.py:278"),
    (pp.scatter_p2g_table_stale,
     "flipviscosity3d_torch/csrc/p2g_scatter_stale.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:714 (inkernel_rank=True,"
     " _rank_from_accumulator :658)"),
    (pp.gather_rows8, "flipviscosity3d_torch/csrc/gather_rows8.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:1265"),
    (pp.scatter_p2g_table_folded,
     "flipviscosity3d_torch/csrc/p2g_scatter.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:714 (fold_sums=True,"
     " _p2g_chunk_values_folded :560)"),
    (pp.scatter_p2g_table_stale_folded,
     "flipviscosity3d_torch/csrc/p2g_scatter_stale.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:714 (inkernel_rank=True,"
     " fold_sums=True, _p2g_chunk_values_folded :560)"),
    (pp.gather_rows, "flipviscosity3d_torch/csrc/gather_rows.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:983"),
    (pp.detile, "flipviscosity3d_torch/csrc/detile.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:459"),
    (probe.scatter_revisit, "flipviscosity3d_torch/csrc/revisit.cu",
     "scripts/gather_perf_probe.py:48"),
    (probe.gather_revisit, "flipviscosity3d_torch/csrc/revisit.cu",
     "scripts/gather_perf_probe.py:83"),
    (proto.tile_scatter, "flipviscosity3d_torch/csrc/tile_proto.cu",
     "scripts/pallas_particle_proto.py:185"),
    (proto.tile_gather, "flipviscosity3d_torch/csrc/tile_proto.cu",
     "scripts/pallas_particle_proto.py:251"),
    (pp.gather_mac_one_grid, "flipviscosity3d_torch/csrc/gather_mac.cu",
     "flipviscosity3d_tpu/ops/pallas_particles.py:1172 (n_grids=1, pass B's"
     " midpoint sample)"),
    (vsolver.viscosity_operator,
     "flipviscosity3d_torch/csrc/visc_operator.cu",
     "none: the JAX package's coupled viscosity operator is XLA"
     " (flipviscosity3d_tpu/solvers/viscosity.py::apply_viscosity_matrix)"),
    (vsolver.compute_volume_grids,
     "flipviscosity3d_torch/csrc/visc_build.cu",
     "none: the JAX package's volume fraction grids are XLA"
     " (flipviscosity3d_tpu/solvers/viscosity.py::compute_volume_grids)"),
    (vsolver.build_viscosity_system,
     "flipviscosity3d_torch/csrc/visc_build.cu",
     "none: the JAX package's viscosity system assembly is XLA"
     " (flipviscosity3d_tpu/solvers/viscosity.py::build_viscosity_system)"),
)
# the kernels of the hardware-check path (run_hw_check)
HW_CHECK_KERNELS = ("gather_rows", "detile", "scatter_revisit",
                    "gather_revisit")
# the kernels of the prototype's path (run_proto)
PROTO_KERNELS = ("tile_scatter", "tile_gather")
# the viscosity solve's kernels: K13 and K14's two wrappers
VISCOSITY_KERNELS = ("viscosity_operator", "compute_volume_grids",
                     "build_viscosity_system")
# every kernel but the solvers' (the V-cycle's and the viscosity
# solve's): none launches on a "table" or "stream" engine path
_PARTICLE_KERNELS = tuple(
    fn.__name__ for fn, _, _ in KERNELS
    if fn.__name__ not in ("mg_down", "mg_up", *VISCOSITY_KERNELS))
BENCH_PARTICLES = 4_111_806   # the JAX bench scene's pool at 128^3
DT = 0.01
STALE_LIFT = 0.43
# The visit-plan variants of the second main path (config.py).
STALE_PATH = dict(pallas_pass_a="stale", pallas_pass_b="plan",
                  pallas_pushback="kernel")
# The main paths chip_smoke.py drives on the "pallas" engine (bench_scene's
# default): (name, frame dt, lift of the pool in y, config overrides).
# "bench" is bench.py's run under BENCH_DEFAULT's engine, "pallas", with its
# default variants; "stale" lets the pool fall with frames long enough for
# several substeps, so that stale substeps occur; "bench_sort" is the bench
# run with pass B "sort" (a re-sort by midpoint key instead of the plan).
MAIN_PATHS = (
    ("bench", DT, 0.0, {}),
    ("stale", 0.04, STALE_LIFT, STALE_PATH),
    ("bench_sort", DT, 0.0, {"pallas_pass_b": "sort"}),
)
# The bench run on the JAX package's two other engines; "table" is its
# default.
ENGINE_PATHS = (
    ("table", DT, 0.0, {"particle_engine": "table"}),
    ("stream", DT, 0.0, {"particle_engine": "stream"}),
)

# The slab pipeline's paths (run_sharded_path): the slabs of the bench
# scene, the kernels a sharded "pallas" substep launches once per slab, and
# the bar of the JAX package's tests/test_shard_step.py:207-234.
SHARDED_SLABS = 4
SHARDED_KERNELS = ("scatter_p2g_table_stale", "gather_mac",
                   "gather_mac_one_grid")
SHARDED_ATOL = 5e-4

# One NVIDIA H100 SXM, peak rates from its datasheet: HBM bytes/s and the
# float32 rate outside the tensor cores, FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def reset_launch_counts() -> None:
    for fn, _, _ in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn, _, _ in KERNELS}


def _scatter_names(cfg: SimConfig):
    """(the scatter a substep under `cfg` launches, the one it must not):
    at >= 2^24 cells the folded form, below it the unfolded."""
    name = ("scatter_p2g_table" if cfg.pallas_pass_a == "sort"
            else "scatter_p2g_table_stale")
    if pp.large_grid(cfg.grid_shape):
        return name + "_folded", name
    return name, name + "_folded"


def path_kernels(cfg: SimConfig) -> list:
    """The kernels a substep under `cfg` launches on the card: the V-cycle's
    under a multigrid preconditioner, the viscosity operator (the scenes of
    these paths are viscous: _main_path_failures fails a path that ran no
    viscosity solve), and under the "pallas" engine its scatter and its
    gathers of two grids (pass A) and one (pass B), and gather_rows8 under
    the kernel pushback. The viscosity solve's kernels are K13 and K14's
    two wrappers (VISCOSITY_KERNELS)."""
    pallas = cfg.particle_engine == "pallas"
    names = ([_scatter_names(cfg)[0], "gather_mac", "gather_mac_one_grid"]
             if pallas else [])
    if "multigrid" in (cfg.pressure_preconditioner,
                       cfg.viscosity_preconditioner):
        names += ["mg_down", "mg_up"]
    names += VISCOSITY_KERNELS
    if pallas and cfg.pallas_pushback == "kernel":
        names.append("gather_rows8")
    return names


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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_main_path(device, res: int, frames: int, dt: float = DT,
                  lift: float = 0.0, log=print, **overrides) -> dict:
    """Drive FluidSimulation on the bench scene (lifted by `lift`, config
    `overrides`): one warm frame, then `frames` timed frames of `dt`. The
    launch counts are set to 0 just before the warm frame and read after
    the last. Returns a dict of results; `failures` lists the checks that
    did not hold; `sim` is the simulation in its final state, for the
    caller to pop."""
    dev = torch.device(device)
    t_setup = time.perf_counter()
    sim = bench_scene(dev, res, lift, **overrides)
    n = int(sim.state.pos.shape[0])
    _sync(dev)
    setup_s = time.perf_counter() - t_setup
    log(json.dumps({"scene": f"{res}^3", "lift": lift, "particles": n,
                    "device": str(dev), "dt": dt, **overrides}))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    diags = []
    for frame in range(frames + 1):
        if frame == 1:
            _sync(dev)
            t0 = time.perf_counter()
        d = sim.advance(dt)
        diags.append(d)
        log(json.dumps({"frame": frame, "warm": frame == 0, **d.as_dict()}))
    _sync(dev)
    wall = time.perf_counter() - t0
    result = _path_result(sim, diags, diags[1:], wall, launch_counts(), dev,
                          setup_s)
    result["sim"] = sim
    return result


def run_gather_dtype_path(device, res: int, frames: int, f32_pos,
                          log=print) -> dict:
    """The bench path under pallas_gather_dtype "bf16", one warm frame and
    `frames` timed frames -> its result (run_main_path's dict) with
    `max_abs_diff_from_f32`: the largest difference between its final
    coordinates and `f32_pos`, those of the same run under "f32" (the
    "bench" main path at the same `res` and `frames`), each axis sorted by
    itself (a particle that changes its cell changes the stream's order, so
    the two states are not compared particle by particle). Fails if the run
    failed or if the two end equal (the field would then not act)."""
    result = run_main_path(device, res, frames, log=log,
                           pallas_gather_dtype="bf16")
    pos = result.pop("sim").state.pos
    if pos.shape != f32_pos.shape:
        result["failures"].append("the two runs hold other particle counts")
        return result
    diff = float((pos.sort(dim=0).values
                  - f32_pos.sort(dim=0).values).abs().max())
    result["max_abs_diff_from_f32"] = diff
    if not diff > 0.0:
        result["failures"].append(
            "final positions under bf16 equal the f32 run's")
    return result


def _path_result(sim, diags, timed, wall, launches, dev, setup_s) -> dict:
    """What a path reports: `diags` every frame's diagnostics, `timed` those
    of the frames that `wall` seconds cover, `launches` the launch counts
    read just after the path. `failures` lists the checks that did not
    hold."""
    substeps = sum(d.substeps for d in timed)
    # over every frame the counts cover, the warm one too
    all_substeps = max(1, sum(d.substeps for d in diags))
    result = {
        "particles": int(sim.state.pos.shape[0]),
        "frames": [d.as_dict() for d in diags],
        "timed_frames": len(timed),
        "substeps": substeps,
        "stale_substeps": sum(d.stale_substeps for d in timed),
        "bucket_overflow": [d.bucket_overflow for d in diags],
        "wall_s": wall,
        "substeps_per_s": substeps / wall,
        "peak_bytes": (torch.cuda.max_memory_allocated()
                       if dev.type == "cuda" else None),
        "launches": launches,
        "launches_per_substep": {k: v / all_substeps
                                 for k, v in launches.items() if v},
        "path_kernels": path_kernels(sim.cfg),
        "setup_s": setup_s,
    }
    result["failures"] = _main_path_failures(sim, diags, result, dev)
    return result


def _main_path_failures(sim, diags, result, dev) -> list:
    failures = []
    pos = sim.state.pos
    lo, his = _clamp_bounds(sim.cfg)
    hi = torch.tensor(his, device=pos.device)
    if not bool(torch.isfinite(pos).all()):
        failures.append("non-finite particle positions")
    elif not bool(((pos >= lo) & (pos <= hi)).all()):
        failures.append("particles outside the clamp bounds")
    for i, d in enumerate(diags):
        for solve in ("pressure", "viscosity"):
            res = getattr(d, solve + "_residual")
            tol = getattr(d, solve + "_tolerance")
            if not res <= tol:
                failures.append(f"frame {i}: {solve} residual {res} above "
                                f"its tolerance {tol}")
    if not any(d.viscosity_iterations > 0 for d in diags):
        failures.append("no frame ran the viscosity solve")
    if dev.type == "cuda":
        launches = result["launches"]
        failures += [f"kernel {k} was never launched"
                     for k in result["path_kernels"] if launches[k] == 0]
        if sim.cfg.particle_engine == "pallas":
            others = [_scatter_names(sim.cfg)[1]]
            why = "on a path of the other sums layout"
        else:
            others = _PARTICLE_KERNELS
            why = f"on a {sim.cfg.particle_engine!r} engine path"
        failures += [f"kernel {k} was launched {launches[k]} times {why}"
                     for k in others if launches[k]]
    return failures


# ---------------------------------------------------------------------------
# kernel vs plain version, on the card
# ---------------------------------------------------------------------------

def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the float32 operations over the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


# float32 operations per (particle, window face) of the Wyvill weight and
# its two sums (p2g_wyvill.cuh): 15 for the offset, 5 for d2, 9 for the
# polynomial, 3 to accumulate.
_P2G_FLOPS_PER_FACE = 32


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, got, want, rtol, atol) -> dict:
    """max abs / rel error of got vs want and whether
    |got - want| <= atol + rtol * |want| everywhere. Works through pieces of
    at most 2^27 elements, so that gigabytes of sums need no temporaries of
    their own size."""
    max_abs = max_rel = 0.0
    ok = True
    pieces = max(1, -(-got.numel() // (1 << 27)))
    for g, w in zip(got.reshape(-1).chunk(pieces),
                    want.reshape(-1).chunk(pieces)):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / w.abs().clamp(min=1e-30)).max()))
        ok = ok and bool((err <= atol + rtol * w.abs()).all()) and bool(
            torch.isfinite(g).all())
    return {"check": name, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "rtol": rtol, "atol": atol, "ok": ok}


def _random_level(shape, gen, device):
    """A diagonally dominant 7-point operator with zero edge links, like the
    premasked systems, and a right-hand side."""
    diag = 1.0 + torch.rand(shape, generator=gen, device=device)
    links = []
    for ax in range(3):
        lk = 0.25 * torch.rand(shape, generator=gen, device=device)
        lk.narrow(1 + ax, shape[1 + ax] - 1, 1).zero_()
        links.append(lk)
    b = torch.randn(shape, generator=gen, device=device)
    return diag, tuple(links), b


def vcycle_level_shapes(shape, cfg: SimConfig) -> dict:
    """The (nb, I, J, K) shapes of the levels above the coarsest, the ones
    mg_down / mg_up run on, of both solves' hierarchies on a grid of
    `shape`: "pressure" from (1, I, J, K), "viscosity" from (3, I+1, J+1,
    K+1) (multigrid.build_hierarchy's rule)."""
    out = {}
    for label, fine in (("pressure", (1,) + tuple(shape)),
                        ("viscosity", (3,) + tuple(s + 1 for s in shape))):
        levels = [fine]
        while (len(levels) < cfg.mg_max_levels
               and min(levels[-1][1:]) > cfg.mg_coarse_size):
            levels.append(pm.coarse_shape(levels[-1]))
        out[label] = levels[:-1]
    return out


def _v_cycle_plain(hier, b, omega, scale):
    """The V(1,1) recursion of multigrid.v_cycle through mg_down_ref /
    mg_up_ref, on the same (bf16-stored) operators as the kernel cycle."""
    def cycle(lvl, b):
        if lvl == len(hier.levels) - 1:
            return mg._coarse_solve(hier, b, 1, 1, omega)
        diag, links = hier.ops[lvl]
        x, rc = pm.mg_down_ref(diag, links, b, omega)
        return pm.mg_up_ref(diag, links, b, x, cycle(lvl + 1, rc), omega,
                            scale)
    return cycle(0, b)


def stale_orders(pos_s, cfg: SimConfig, gen) -> dict:
    """Two stale orders of sorted positions `pos_s`, clamped into the
    domain: "falling" lifts them by the stale path's lift and moves every
    particle down by 0.8 to 1.0 times one CFL substep (cfl_number cells),
    smoothly along x, as one substep of that path's falling pool does;
    "random steps" moves each by uniform steps of up to 1.5 cells per
    axis."""
    dx = cfg.dx
    lo, his = _clamp_bounds(cfg)
    hi = torch.tensor(his, device=pos_s.device)
    x = pos_s[:, 0] / (cfg.isize * dx)
    fall = pos_s.clone()
    fall[:, 1] += STALE_LIFT - cfg.cfl_number * dx * (
        0.8 + 0.2 * torch.sin(2.0 * math.pi * x))
    steps = pos_s + dx * (3.0 * torch.rand(pos_s.shape, generator=gen,
                                           device=pos_s.device) - 1.5)
    return {label: torch.minimum(torch.clamp(p, min=lo), hi)
            for label, p in (("falling", fall), ("random steps", steps))}


def _max_abs(t) -> float:
    lo, hi = t.aminmax()
    return max(-float(lo), float(hi))


def _scatter_checks(label, kernel, plain, cfg: SimConfig, extra) -> tuple:
    """One scatter in both layouts of its sums -> (the unfolded kernel's
    checks, the folded kernel's). `kernel(fold)` and `plain(fold)` give
    (sums, table[, counts]). Unfolded: the sums against the plain version's
    at rtol 1e-5 and atol 1e-6 * max|sums|, table (and counts) exact, and
    the checks `extra(kernel's, plain's)` adds. Folded: lanes 0..107 of each
    cell, the table and the counts torch.equal to the unfolded kernel's, the
    pad lanes exactly 0, the face combine in 8 slabs over the folded sums
    torch.equal to the unslabbed one over the unfolded sums, and the sums
    against the plain folded version at the same tolerance. At most two
    kernel outputs and one plain output are alive at a time."""
    shape = cfg.grid_shape
    faces = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    got = kernel(False)
    want = plain(False)
    checks = [compare(f"{label}sums", got[0], want[0], 1e-5,
                      1e-6 * _max_abs(want[0])),
              {"check": f"{label}table exact",
               "ok": bool(torch.equal(got[1], want[1]))}]
    checks += extra(got, want)
    del want
    folded = kernel(True)
    fs = folded[0].reshape(*shape, pp.SUML)
    slabbed = pp.p2g_combine(folded[0], shape, faces, i_slabs=8)
    whole = pp.p2g_combine(got[0], shape, faces, i_slabs=1)
    fchecks = [
        {"check": f"{label}lanes 0..107 equal the unfolded kernel's",
         "ok": bool(torch.equal(fs[..., :pp.N_P2G], got[0]))},
        {"check": f"{label}pad lanes exactly 0",
         "ok": bool((fs[..., pp.N_P2G:] == 0).all())},
        {"check": f"{label}table and counts equal the unfolded kernel's",
         "ok": all(bool(torch.equal(a, b))
                   for a, b in zip(folded[1:], got[1:]))},
        {"check": f"{label}p2g_combine in 8 slabs over the folded sums "
                  "equals the unslabbed one over the unfolded sums",
         "ok": all(bool(torch.equal(a, b)) for pa, pb in zip(slabbed, whole)
                   for a, b in zip(pa, pb))},
    ]
    del got, slabbed, whole
    want = plain(True)
    fchecks.append(compare(f"{label}sums vs the plain folded version",
                           folded[0], want[0], 1e-5,
                           1e-6 * _max_abs(want[0])))
    return checks, fchecks


# the pallas_split_terms settings the particle kernels are held at: the
# exact products (the default) first, then the JAX package's two splits
SPLIT_TERMS = (3, 1, 2)


def _terms_label(terms: int) -> str:
    return "" if terms == 3 else f"terms {terms}: "


def scatter_bound(inputs, n_cells: int, cap: int, stride: int) -> dict:
    """K1's bound: its inputs (positions, velocities, keys, ranks) read
    once, a row of `stride` sums and cap slots written per cell, and the
    Wyvill weights and sums of the 54 window faces of every particle."""
    n = inputs[0].shape[0]
    return bound(_nbytes(*inputs) + (4 * stride + 16 * cap) * n_cells,
                 _P2G_FLOPS_PER_FACE * 54 * n)


def stale_scatter_bound(args5, n_cells: int, cap: int, stride: int) -> dict:
    """K5's bound for scatter_p2g_table_stale's arguments (pos, vel, key,
    plan, ...): the particles and the plan read once, a row of `stride`
    sums, cap slots and a count written per cell, and the Wyvill weights and
    sums of the 54 window faces of every covered particle."""
    pos, vel, key, plan = args5[:4]
    return bound(_nbytes(pos, vel, key, plan.covered, plan.tile_ptr,
                         plan.tile_chunks)
                 + (4 * stride + 16 * cap + 4) * n_cells,
                 _P2G_FLOPS_PER_FACE * 54 * int(plan.covered.sum()))


def tile_scatter_bound(payload, starts, cap: int, n: int) -> dict:
    """K11's bound: the payload and the run starts read once, a row of 108 +
    4 cap floats written per cell, and the Wyvill weights and sums of the 54
    window faces of each of the n particles."""
    n_cells = (starts.shape[0] - 1) * proto.W
    return bound(_nbytes(payload, starts)
                 + 4 * (proto.N_SUM + 4 * cap) * n_cells,
                 _P2G_FLOPS_PER_FACE * 54 * n)


def gather_bound(args) -> dict:
    """K2's bound for gather_mac's arguments (px, py, pz, keys, grids_u,
    grids_v, grids_w, ...): positions, keys and every grid read once, 3
    samples per grid written per particle; per particle 3 divisions and per
    component 12 operations for the axes' fractions and weights, 16 for the
    8 corner weights and 16 per grid to weight and add the corners."""
    px, py, pz, keys, gu, gv, gw = args[:7]
    n, n_grids = px.shape[0], len(gu)
    return bound(_nbytes(px, py, pz, keys, *gu, *gv, *gw) + 12 * n_grids * n,
                 (3 + 3 * (12 + 16 + 16 * n_grids)) * n)


def midpoints(pos, cfg: SimConfig, gen):
    """Pass B's stand-in midpoints for the kernel checks: the positions
    moved by normal steps of 3 cells per axis, in their order, so that some
    leave the domain -> (mx, my, mz, their tile-major keys, how many lie
    outside)."""
    dx, shape = cfg.dx, cfg.grid_shape
    mid = pos + 3.0 * dx * torch.randn(pos.shape, generator=gen,
                                       device=pos.device)
    outside = int(((mid < 0) | (mid >= shape[0] * dx)).any(dim=1).sum())
    return (*(mid[:, a].contiguous() for a in range(3)),
            pp.key_of_position(mid, dx, shape), outside)


def grid_sample_mac(px, py, pz, grids_u, grids_v, grids_w, dx, grid_shape):
    """The library call that computes K2's pass-A samples: per component one
    torch.nn.functional.grid_sample (trilinear, zeros outside the grid,
    align_corners=True) with the grids as channels, at the positions in the
    component's index frame. Equal to gather_mac where every particle's
    corners lie in its home cell's window, as pass A's do. The inputs are
    laid out here; the returned function makes the three calls -> (3 *
    n_grids, N) samples, rows g*3 + comp."""
    n = px.shape[0]
    calls = []
    for comp, grids in enumerate((grids_u, grids_v, grids_w)):
        image = torch.stack(list(grids))[None]        # (1, G, D, H, W)
        size = image.shape[2:]
        coords = [(p / dx - pp._MAC_OFFSETS[comp][ax]) * (2.0 / (size[ax] - 1))
                  - 1.0 for ax, p in enumerate((px, py, pz))]
        # grid_sample's last axis runs (W, H, D): (z, y, x)
        where = torch.stack(coords[::-1], dim=1).reshape(1, 1, 1, n, 3)
        calls.append((image, where))

    def run():
        out = [torch.nn.functional.grid_sample(
            image, where, mode="bilinear", padding_mode="zeros",
            align_corners=True).reshape(-1, n) for image, where in calls]
        return torch.stack(out, dim=1).reshape(-1, n)

    return run


def check_kernels(state, cfg: SimConfig, seed: int = 0, log=print,
                  ref_slabs: int = 1) -> list:
    """Each kernel against its plain version on the card at the shapes the
    main paths give it (the plain scatters in `ref_slabs` runs of particles:
    one at 128^3, more where their values would not fit the card beside the
    sums): K1 on the scene's sorted particles at each of SPLIT_TERMS; K2
    torch.equal at each of them with two grids at the particles and, as the
    gather_mac_one_grid record, one grid at midpoints (some outside the
    domain), its library call grid_sample_mac; K3/K4 torch.equal at every
    level of the pressure (1,I,J,K) and the viscosity (3,I+1,J+1,K+1)
    hierarchy with the bf16 and the f32 operator, each level timed cold and
    warm beside its bound (the mg_down record's `levels`), and a whole
    V-cycle of each (_vcycle_records); K5 and K6 through plans of cfg's
    budgets over the two stale_orders of the sorted particles, timed on
    "falling" (where K5 is also held at the split terms); K1 and K5 in both
    layouts of their sums, whichever the grid's size would choose
    (_scatter_checks); K7-K10 (_column_records); K11 and K12 on the
    prototype's own input (_proto_records); K13 on a random premasked
    operator (_viscosity_operator_record); K14's two wrappers on the bench
    pool's liquid (_visc_build_records); K5, K2 and
    gather_mac_one_grid once more at the sharded paths' inputs, one
    slab's local grid and key-sorted stream with its dead rows, their
    checks added to those records (_slab_checks). Returns
    one record per kernel with its checks, the kernel's, the plain version's
    and the library call's times, and its bound."""
    dev = state.pos.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape, dx, cap = cfg.grid_shape, cfg.dx, cfg.sdf_cap
    n = state.pos.shape[0]
    n_cells = cfg.n_cells
    records = {}

    # K1: P2G scatter + slot table, at every split-terms setting
    vel = 0.5 * torch.randn((n, 3), generator=gen, device=dev)
    stream = pp.tiled_sort(state.pos, vel, dx, shape)
    args = (stream.pos, stream.vel, stream.key, stream.rank, shape, dx, cap)
    overflow = int((stream.rank >= cap).sum())

    def k1(fold, terms=3):
        return pp.scatter_p2g_table(*args, fold_sums=fold, terms=terms)

    def k1_plain(fold, terms=3):
        return pp.scatter_p2g_table_ref(*args, fold_sums=fold,
                                        slabs=ref_slabs, terms=terms)

    def k1_overflow(got, want):
        occupied = int(got[1][..., 3].sum(dtype=torch.float64))
        return [{"check": "overflow", "kernel": n - occupied,
                 "plain": overflow, "ok": n - occupied == overflow}]

    checks, fchecks = [], []
    for terms in SPLIT_TERMS:
        c, f = _scatter_checks(
            _terms_label(terms), lambda fold, t=terms: k1(fold, t),
            lambda fold, t=terms: k1_plain(fold, t), cfg,
            k1_overflow if terms == 3 else lambda got, want: [])
        checks += c
        fchecks += f
    records["scatter_p2g_table"] = (
        checks, _times(lambda: k1(False), lambda: k1_plain(False)),
        scatter_bound(args[:4], n_cells, cap, pp.N_P2G))
    records["scatter_p2g_table_folded"] = (
        fchecks, _times(lambda: k1(True), lambda: k1_plain(True)),
        scatter_bound(args[:4], n_cells, cap, pp.SUML))

    # K2: G2P gather, pass A (2 grids) and pass B (1 grid at midpoints)
    faces = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    grids = [[torch.randn(fs, generator=gen, device=dev) for fs in faces]
             for _ in range(2)]
    gu, gv, gw = ([grids[0][c], grids[1][c]] for c in range(3))
    px, py, pz = (stream.pos[:, a].contiguous() for a in range(3))
    args_a = (px, py, pz, stream.key, gu, gv, gw, dx, shape)
    mx, my, mz, key_m, outside = midpoints(stream.pos, cfg, gen)
    args_b = (mx, my, mz, key_m, gu[0], gv[0], gw[0], dx, shape)
    plain_b = (mx, my, mz, key_m, gu[:1], gv[:1], gw[:1], dx, shape)

    def split():
        """Pass A's gather as the JAX package splits it at >= 2^24 cells:
        one launch per grid."""
        return torch.cat([pp.gather_mac(px, py, pz, stream.key, gu[g:g + 1],
                                        gv[g:g + 1], gw[g:g + 1], dx, shape)
                          for g in range(2)])

    checks, checks_b = [], []
    for terms in SPLIT_TERMS:
        label = _terms_label(terms)
        checks.append(_equal(f"{label}n_grids=2 at particles",
                             pp.gather_mac(*args_a, terms=terms),
                             pp.gather_mac_ref(*args_a, terms=terms)))
        checks_b.append(_equal(
            f"{label}n_grids=1 at midpoints ({outside} outside the domain)",
            pp.gather_mac_one_grid(*args_b, terms=terms),
            pp.gather_mac_ref(*plain_b, terms=terms)))
    fused = pp.gather_mac(*args_a)
    library = grid_sample_mac(px, py, pz, gu, gv, gw, dx, shape)
    checks += [
        # why pallas_split_gather changes nothing in the port (config.py)
        {"check": "two launches of one grid each equal the launch of two",
         "ok": bool(torch.equal(split(), fused)),
         "ms_two_launches": time_ms(split)},
        # the library call computes the same function with its own
        # arithmetic (coordinates scaled to [-1, 1] and back): its
        # difference is reported, not checked
        {"check": "grid_sample (the library call) vs the kernel",
         "library_max_abs_err": _max_abs(library() - fused), "ok": True}]
    del fused
    records["gather_mac"] = (
        checks, _times(lambda: pp.gather_mac(*args_a),
                       lambda: pp.gather_mac_ref(*args_a), library),
        gather_bound(args_a))
    del library
    records["gather_mac_one_grid"] = (
        checks_b, _times(lambda: pp.gather_mac_one_grid(*args_b),
                         lambda: pp.gather_mac_ref(*plain_b)),
        gather_bound(plain_b))

    # K3 / K4 at every level of both solves' hierarchies
    records.update(_vcycle_records(cfg, dev, gen))
    # K13 on the grid's three face shapes
    records["viscosity_operator"] = _viscosity_operator_record(cfg, dev, gen)
    # K14 on a pool's liquid at the grid's shapes
    records.update(_visc_build_records(cfg, dev, gen))

    # K5 / K6 over two stale orders of the sorted particles: "falling", one
    # CFL substep of the stale path's fall (its regime: every particle
    # covered), which times them; and
    # "random steps" of up to 1.5 cells, where the plans' capacity leaves a
    # tail of the stream uncovered. The K6 library call indexes a
    # precomputed tile-major (n_cells, 8) corner table.
    phi = state.solid.phi
    every = torch.arange(n_cells, dtype=torch.int32, device=dev)
    corner_table = pp.gather_rows8_ref(
        every, torch.ones_like(every, dtype=torch.bool), phi,
        shape).t().contiguous()
    checks5, checks5f, checks6 = [], [], []
    for label, moved in stale_orders(stream.pos, cfg, gen).items():
        key5 = pp.key_of_position(moved, dx, shape)
        plan = pp.plan_pass_a(key5, shape, cfg.pallas_passa_budget,
                              cfg.pallas_passa_factor)
        covered = int(plan.covered.sum())
        args5 = (moved, stream.vel, key5, plan, shape, dx, cap)
        ref5 = (moved, stream.vel, key5, plan.covered, shape, dx, cap)
        full = label == "falling"

        def k5(fold, a=args5):
            return pp.scatter_p2g_table_stale(*a, fold_sums=fold)

        def k5_plain(fold, a=ref5):
            return pp.scatter_p2g_table_stale_ref(*a, fold_sums=fold,
                                                  slabs=ref_slabs)

        def k5_counts(got, want, covered=covered, plan=plan, full=full):
            return [
                {"check": f"{label}: counts exact",
                 "ok": bool(torch.equal(got[2], want[2])),
                 "max_count": int(got[2].max()),
                 "rank_overflow": int(pp.table_rank_overflow(got[2], cap))},
                {"check": f"{label}: coverage", "covered": covered,
                 "particles": n, "incidences": int(plan.tile_chunks.numel()),
                 "ok": covered == n if full else covered > 0}]

        c5, c5f = _scatter_checks(f"{label}: ", k5, k5_plain, cfg, k5_counts)
        checks5 += c5
        checks5f += c5f
        if full:
            # the split products, unfolded
            for terms in SPLIT_TERMS[1:]:
                got = pp.scatter_p2g_table_stale(*args5, terms=terms)
                want = pp.scatter_p2g_table_stale_ref(*ref5, slabs=ref_slabs,
                                                      terms=terms)
                tag = f"{label}: {_terms_label(terms)}"
                checks5 += [
                    compare(f"{tag}sums", got[0], want[0], 1e-5,
                            1e-6 * _max_abs(want[0])),
                    {"check": f"{tag}table and counts exact",
                     "ok": all(bool(torch.equal(a, b))
                               for a, b in zip(got[1:], want[1:]))}]
                del got, want
        cov6 = pp.plan_midpoint_visits(key5, cfg.pallas_midpoint_budget,
                                       cfg.pallas_midpoint_factor).covered
        args6 = (key5, cov6, phi, shape)
        checks6 += [
            compare(f"{label}: corners exact", pp.gather_rows8(*args6),
                    pp.gather_rows8_ref(*args6), 0.0, 0.0),
            {"check": f"{label}: coverage", "covered": int(cov6.sum()),
             "particles": n, "ok": bool(cov6.all()) if full
             else bool(cov6.any())}]
        if not full:
            partial = (key5, cov6)   # K7's partly covered random order
        if full:
            idx5 = key5.long()
            records["scatter_p2g_table_stale"] = (
                checks5, _times(lambda: k5(False), lambda: k5_plain(False)),
                stale_scatter_bound(args5, n_cells, cap, pp.N_P2G))
            records["scatter_p2g_table_stale_folded"] = (
                checks5f, _times(lambda: k5(True), lambda: k5_plain(True)),
                stale_scatter_bound(args5, n_cells, cap, pp.SUML))
            records["gather_rows8"] = (
                checks6,
                _times(lambda: pp.gather_rows8(*args6),
                       lambda: pp.gather_rows8_ref(*args6),
                       lambda: torch.index_select(corner_table, 0, idx5)),
                bound(_nbytes(key5, cov6, phi) + 32 * n, 0))
            del idx5

    records.update(_column_records(stream.key, partial, (gu, gv, gw), shape,
                                   gen))
    records.update(_proto_records(cfg, dev, gen))
    for name, slab in _slab_checks(state, cfg, gen, ref_slabs).items():
        records[name][0].extend(slab)

    out = []
    for fn, source, replaces in KERNELS:
        checks, times, bnd = records[fn.__name__]
        rec = {
            "name": fn.__name__, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": max(c.get("max_abs_err", 0.0) for c in checks),
            **times, **bnd,
            "ok": all(c["ok"] for c in checks), "checks": checks,
        }
        levels = rec.pop("levels", [])
        log(json.dumps(rec))
        for line in levels:
            log(json.dumps({"vcycle_level": line}))
        if levels:
            rec["levels"] = levels
        out.append(rec)
    return out


def _slab_checks(state, cfg: SimConfig, gen, ref_slabs: int) -> dict:
    """K5, K2 and gather_mac_one_grid at the inputs the sharded "pallas"
    paths give them: an inner slab (rank 1 of SHARDED_SLABS) of `state` as
    shard_simstate cuts it, its local grid (B + 2H, J, K), its particles in
    slab-local x with the dead rows of its capacity, sorted and planned by
    shard_step.slab_stream (dead rows keyed _IMAX, last, uncovered). At
    each of SPLIT_TERMS: K5 against its plain version (sums within rtol
    1e-5 and atol 1e-6 * max|sums|, table and counts exact); K2 with two
    random grids of the slab's face shapes (u's cropped row padded back as
    zeros, as the slab substep pads it) and with one at midpoints (the
    sorted positions moved by normal steps of 3 cells, dead rows keyed
    _IMAX) torch.equal to gather_mac_ref -> {kernel name: checks}."""
    from .parallel import shard_step as sh

    rank, dx, cap = 1, cfg.dx, cfg.sdf_cap
    spec = sh.make_spec(cfg, SHARDED_SLABS,
                        n_particles=int(state.pos.shape[0]))
    ss = sh.shard_simstate(state, cfg, spec)
    pos, vel, alive = (t[rank].clone() for t in (ss.pos, ss.vel, ss.alive))
    faces = tuple(tuple(t.shape[1:]) for t in (ss.u, ss.v, ss.w))
    del ss
    local = faces[0]
    px = pos[:, 0] - float(sh.slab_origin(rank, spec, dx))
    fields, salive, key, plan = sh.slab_stream(
        px, pos[:, 1], pos[:, 2], *vel.unbind(dim=1), alive, cfg, local)
    del pos, vel, px
    spos = torch.stack(fields[:3], dim=1)
    svel = torch.stack(fields[3:], dim=1)
    n_alive, covered = int(salive.sum()), int(plan.covered.sum())
    tag = (f"slab {rank} of {SHARDED_SLABS} ({'x'.join(map(str, local))}, "
           f"{n_alive} alive, {key.shape[0] - n_alive} dead rows): ")
    k5 = [{"check": f"{tag}coverage", "covered": covered,
           "alive": n_alive, "ok": covered == n_alive}]
    for terms in SPLIT_TERMS:
        got = pp.scatter_p2g_table_stale(spos, svel, key, plan, local, dx,
                                         cap, terms=terms)
        want = pp.scatter_p2g_table_stale_ref(spos, svel, key, plan.covered,
                                              local, dx, cap,
                                              slabs=ref_slabs, terms=terms)
        label = tag + _terms_label(terms)
        k5 += [compare(f"{label}sums", got[0], want[0], 1e-5,
                       1e-6 * _max_abs(want[0])),
               {"check": f"{label}table and counts exact",
                "ok": all(bool(torch.equal(a, b))
                          for a, b in zip(got[1:], want[1:]))}]
        del got, want
    grids = []
    for _ in range(2):
        gu, gv, gw = (torch.randn(fs, generator=gen, device=spos.device)
                      for fs in faces)
        grids.append((torch.nn.functional.pad(gu, (0, 0, 0, 0, 0, 1)), gv,
                      gw))
    gu2, gv2, gw2 = ([g[c] for g in grids] for c in range(3))
    spx, spy, spz = fields[:3]
    mid = spos + 3.0 * dx * torch.randn(spos.shape, generator=gen,
                                        device=spos.device)
    key_m = torch.where(salive, pp.key_of_position(mid, dx, local),
                        torch.full_like(key, sh._IMAX))
    mx, my, mz = (mid[:, a].contiguous() for a in range(3))
    k2, k2b = [], []
    for terms in SPLIT_TERMS:
        label = tag + _terms_label(terms)
        k2.append(_equal(
            f"{label}n_grids=2 at particles",
            pp.gather_mac(spx, spy, spz, key, gu2, gv2, gw2, dx, local,
                          terms),
            pp.gather_mac_ref(spx, spy, spz, key, gu2, gv2, gw2, dx, local,
                              terms)))
        k2b.append(_equal(
            f"{label}n_grids=1 at midpoints",
            pp.gather_mac_one_grid(mx, my, mz, key_m, *grids[0], dx, local,
                                   terms),
            pp.gather_mac_ref(mx, my, mz, key_m, *([g] for g in grids[0]),
                              dx, local, terms)))
    k5_name = "scatter_p2g_table_stale" + (
        "_folded" if pp.large_grid(local) else "")
    return {k5_name: k5, "gather_mac": k2, "gather_mac_one_grid": k2b}


# bytes written between two cold launches: more than the 50 MB L2 holds
_FLUSH_BYTES = 256 << 20
# the head start, in device clock cycles, a timed batch is queued behind,
# so that the host's launch cost stays out of the device's time
_HEAD_START_CYCLES = 2_000_000


def device_ms(fn, flush=None, count: int = 10, repeats: int = 5) -> float:
    """Device milliseconds of one fn() call, the median of `repeats`
    batches. Each batch is queued behind torch.cuda._sleep, so the host has
    enqueued it before the device reaches its first CUDA event, and is
    timed by a pair of events: without `flush`, `count` back-to-back calls
    (inputs warm in L2 where they fit); with `flush`, one call after
    flush() has written past L2 (cold inputs), the flush outside the
    events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        if flush is not None:
            flush()
        torch.cuda._sleep(_HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        calls = 1 if flush is not None else count
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def _equal(name, got, want) -> dict:
    """torch.equal of two outputs, with their largest difference."""
    rec = compare(name, got, want, 0.0, 0.0)
    rec["ok"] = bool(torch.equal(got, want))
    return rec


def _vcycle_records(cfg: SimConfig, dev, gen) -> dict:
    """The records of K3 mg_down and K4 mg_up for check_kernels. For each
    solve (vcycle_level_shapes of cfg's grid) a random diagonally dominant
    fine operator is coarsened by multigrid.build_hierarchy; at every level
    above the coarsest, with the operator stored in bf16 (the hierarchy's
    own, cfg.mg_operator_dtype) and in f32 and a random b and xc, each
    kernel is held torch.equal to its plain version; a whole V-cycle is
    held torch.equal to _v_cycle_plain. Each bf16 level is timed: the
    kernel back to back (`ms`) and cold (`ms_cold`, L2 flushed before each
    launch; the inputs of the levels under ~50 MB otherwise stay in L2 and
    read faster than the bound allows), the plain version, and the bound
    of its bytes. The records' own times and bound are the viscosity fine
    level's (the series of the earlier records); `levels` holds one line
    per level."""
    on_card = torch.device(dev).type == "cuda"
    flush_buf = torch.empty(_FLUSH_BYTES // 4 if on_card else 1, device=dev)
    flush = flush_buf.zero_
    omega, scale = cfg.mg_omega, cfg.mg_coarse_scale
    checks = {"mg_down": [], "mg_up": []}
    levels = []
    timed = {}
    for label, shapes in vcycle_level_shapes(cfg.grid_shape, cfg).items():
        diag, links, b = _random_level(shapes[0], gen, dev)
        hier = mg.build_hierarchy(diag, links, cfg)
        del diag, links
        assert [tuple(op[0].shape) for op in hier.ops] == shapes
        cyc = _equal(f"{label} whole V-cycle ({len(hier.levels)} levels)",
                     mg.v_cycle(hier, b, 1, 1, omega, scale),
                     _v_cycle_plain(hier, b, omega, scale))
        del b
        checks["mg_down"].append(cyc)
        checks["mg_up"].append(cyc)
        for lvl, (ops, level) in enumerate(zip(hier.ops, hier.levels)):
            shape = tuple(ops[0].shape)
            bl = torch.randn(shape, generator=gen, device=dev)
            xc = torch.randn(pm.coarse_shape(shape), generator=gen,
                             device=dev)
            line = {"system": label, "level": lvl, "shape": list(shape),
                    "chunk": pm._chunk(bl) if on_card else None}
            for own, (d, lk) in enumerate((ops, (
                    level.diag.contiguous(),
                    tuple(a.contiguous() for a in level.links)))):
                tag = "bf16" if d.dtype == torch.bfloat16 else "f32"
                xk, rck = pm.mg_down(d, lk, bl, omega)
                xr, rcr = pm.mg_down_ref(d, lk, bl, omega)
                checks["mg_down"] += [
                    _equal(f"{label} {shape} {tag} x", xk, xr),
                    _equal(f"{label} {shape} {tag} rc", rck, rcr)]
                up = (d, lk, bl, xr, xc, omega, scale)
                outk = pm.mg_up(*up)
                checks["mg_up"].append(_equal(f"{label} {shape} {tag} out",
                                              outk, pm.mg_up_ref(*up)))
                line[f"equal_{tag}"] = all(
                    c["ok"] for c in (checks["mg_down"][-2:]
                                      + checks["mg_up"][-1:]))
                if own == 0:   # the hierarchy's own storage is timed
                    down = (d, lk, bl, omega)
                    line["mg_down"] = _level_times(
                        lambda: pm.mg_down(*down),
                        lambda: pm.mg_down_ref(*down), flush, on_card,
                        bound(_nbytes(d, *lk, bl, xk, rck),
                              18 * bl.numel()))
                    line["mg_up"] = _level_times(
                        lambda: pm.mg_up(*up), lambda: pm.mg_up_ref(*up),
                        flush, on_card,
                        bound(_nbytes(d, *lk, bl, xr, xc, outk),
                              20 * bl.numel()))
                del xk, rck, xr, rcr, outk
            levels.append(line)
            if label == "viscosity" and lvl == 0:
                for name in ("mg_down", "mg_up"):
                    t = line[name]
                    timed[name] = (
                        {"ms": t["ms"], "plain_ms": t["plain_ms"],
                         "library_ms": None},
                        {k: t[k] for k in ("bound_ms", "bound_by", "bytes",
                                           "flops")})
        del hier
    del flush_buf
    timed["mg_down"][0]["levels"] = levels
    return {name: (checks[name], *timed[name])
            for name in ("mg_down", "mg_up")}


def random_viscosity_operator(faces, gen, device):
    """A coupled viscosity operator on the three face shapes `faces`, as
    build_viscosity_system leaves it: per component six factor grids in
    [0, 1) and a diagonal in [1, 7), premasked to a random three quarters
    of the rows (0 elsewhere; rows on the grid's edges too, whose
    neighbours out of range the operator reads as 0), and an x of normal
    values -> (factors, diag, x)."""
    factors, diag, x = [], [], []
    for fs in faces:
        rows = torch.rand(fs, generator=gen, device=device) < 0.75
        zero = torch.zeros(fs, device=device)
        factors.append({key: torch.where(
            rows, torch.rand(fs, generator=gen, device=device), zero)
            for key in vsolver._KEYS})
        diag.append(torch.where(
            rows, 1.0 + 6.0 * torch.rand(fs, generator=gen, device=device),
            zero))
        x.append(torch.randn(fs, generator=gen, device=device))
    return tuple(factors), tuple(diag), tuple(x)


def _viscosity_operator_record(cfg: SimConfig, dev, gen) -> tuple:
    """The record of K13 viscosity_operator for check_kernels: on a random
    operator at cfg's face shapes (random_viscosity_operator), torch.equal
    to viscosity_operator_ref with the diagonal (a CG apply) and without
    it (the build's RHS coupling); the kernel timed back to back and cold,
    the plain version, and the bound of 27 grids read or written once."""
    on_card = torch.device(dev).type == "cuda"
    faces = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    factors, diag, x = random_viscosity_operator(faces, gen, dev)
    checks, y = [], None
    for label, d in (("diag * x + C(x)", diag), ("C(x)", None)):
        y = vsolver.viscosity_operator(factors, x, d)
        checks.append(_equal(label, torch.cat([t.reshape(-1) for t in y]),
                             torch.cat([t.reshape(-1) for t in
                                        vsolver.viscosity_operator_ref(
                                            factors, x, d)])))
    grids = [g for fac in factors for g in fac.values()]
    bnd = bound(_nbytes(*grids, *diag, *x, *y),
                30 * sum(t.numel() for t in x))
    flush_buf = torch.empty(_FLUSH_BYTES // 4 if on_card else 1, device=dev)
    times = _level_times(
        lambda: vsolver.viscosity_operator(factors, x, diag),
        lambda: vsolver.viscosity_operator_ref(factors, x, diag),
        flush_buf.zero_, on_card, bnd)
    del flush_buf
    times = {k: times[k] for k in ("ms", "ms_cold", "plain_ms",
                                   "cold_over_bound")}
    return checks, {**times, "library_ms": None}, bnd


# the liquid fields K14 is held to its plain version on
VISC_BUILD_FIELDS = ("pool", "sphere", "flat", "random", "zeros",
                     "all_liquid", "dry")


def visc_build_phi(shape, field, gen, device) -> torch.Tensor:
    """A liquid phi of `shape` in cells for K14's checks: "pool" the
    bench pool's box (2.5 cells off the walls, up to 28.5% of J; the max of
    the signed distances to its six planes), "sphere" the signed distance
    to a ball of a third of the shortest extent, "flat" a free surface at
    30% of J, "random" normal values, "zeros" values drawn from {-1, -0.5,
    0, 0.5, 1} (exact zeros: the ties of < 0 and <= 0, _safe_div's zero
    branch), "all_liquid" -1 and "dry" +1 everywhere."""
    if field == "random":
        return torch.randn(shape, generator=gen, device=device)
    if field == "zeros":
        return 0.5 * torch.randint(-2, 3, shape, generator=gen,
                                   device=device).float()
    if field in ("all_liquid", "dry"):
        return torch.full(shape, -1.0 if field == "all_liquid" else 1.0,
                          device=device)
    at = torch.meshgrid(*(torch.arange(n, dtype=torch.float32,
                                       device=device) + 0.5
                          for n in shape), indexing="ij")
    if field == "flat":
        return (at[1] - 0.3 * shape[1]).contiguous()
    if field == "sphere":
        r2 = sum((x - n / 2) ** 2 for x, n in zip(at, shape))
        return (r2.sqrt() - min(shape) / 3).contiguous()
    top = (shape[0] - 2.5, 0.285 * shape[1], shape[2] - 2.5)
    planes = [d for x, hi in zip(at, top) for d in (2.5 - x, x - hi)]
    return torch.stack(planes).amax(dim=0)


def visc_build_inputs(phi, faces, gen, device, visc_shape=None) -> tuple:
    """The rest of build_viscosity_system's inputs around liquid `phi`:
    velocities of normal values on the face shapes `faces`; solid faces on
    each component's first and last plane along its own axis and on a
    random tenth of the others; viscosity nodes of `visc_shape` (phi's
    shape + 1 unless given) in [1, 5) with a tenth of them 0 -> (u, v, w,
    FaceStates, viscosity)."""
    vels, solids = [], []
    for axis, fs in enumerate(faces):
        vels.append(torch.randn(fs, generator=gen, device=device))
        solid = torch.rand(fs, generator=gen, device=device) < 0.1
        solid.narrow(axis, 0, 1).fill_(True)
        solid.narrow(axis, fs[axis] - 1, 1).fill_(True)
        solids.append(solid)
    visc_shape = visc_shape or tuple(n + 1 for n in phi.shape)
    visc = 1.0 + 4.0 * torch.rand(visc_shape, generator=gen, device=device)
    visc[torch.rand(visc_shape, generator=gen, device=device) < 0.1] = 0.0
    return (*vels, vsolver.FaceStates(*solids), visc)


def visc_system_grids(system) -> dict:
    """A ViscositySystem's outputs by name, each flattened and joined over
    the components: in_mat, diag, vol, the 18 factors and rhs."""
    def cat(ts):
        return torch.cat([t.reshape(-1) for t in ts])

    return {"in_mat": cat(system.in_mat), "diag": cat(system.diag),
            "vol": cat(system.vol),
            "factors": cat([f[k] for f in system.factors
                            for k in vsolver._KEYS]),
            "rhs": cat(system.rhs)}


def _visc_build_records(cfg: SimConfig, dev, gen) -> dict:
    """The records of K14's two wrappers for check_kernels, on the bench
    pool's liquid ("pool" of visc_build_phi) at cfg's grid with
    visc_build_inputs around it: compute_volume_grids' 7 grids and
    build_viscosity_system's outputs (visc_system_grids) torch.equal to
    their plain versions; each wrapper timed back to back and cold, the
    plain version, and the bound of the bytes its inputs and outputs need
    once (the build's: the velocities, solid masks, volume grids and
    viscosity read, its outputs written; not K13's Dirichlet velocities and
    coupling in between)."""
    on_card = torch.device(dev).type == "cuda"
    shape = cfg.grid_shape
    phi = visc_build_phi(shape, "pool", gen, dev)
    faces = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    u, v, w, states, visc = visc_build_inputs(phi, faces, gen, dev)
    dt = 0.004

    def volumes():
        return vsolver.compute_volume_grids(phi, cfg)

    def volumes_ref():
        return vsolver.compute_volume_grids_ref(phi, cfg)

    got, want = volumes(), volumes_ref()
    grids = [getattr(got, f.name) for f in dataclasses.fields(got)]
    checks_v = [_equal(f"{f.name} ({'x'.join(map(str, g.shape))})", g,
                       getattr(want, f.name))
                for f, g in zip(dataclasses.fields(got), grids)]
    del want

    def system():
        return vsolver.build_viscosity_system(u, v, w, got, states, visc, dt,
                                              cfg)

    def system_ref():
        return vsolver.build_viscosity_system_ref(u, v, w, got, states, visc,
                                                  dt, cfg)

    out, ref = visc_system_grids(system()), visc_system_grids(system_ref())
    checks_s = [_equal(name, out[name], ref[name]) for name in out]
    solids = (states.solid_u, states.solid_v, states.solid_w)
    bnd_v = bound(_nbytes(phi, *grids), 0)
    bnd_s = bound(_nbytes(u, v, w, *solids, *grids, visc, *out.values()), 0)
    del out, ref
    flush_buf = torch.empty(_FLUSH_BYTES // 4 if on_card else 1, device=dev)
    keys = ("ms", "ms_cold", "plain_ms", "cold_over_bound")
    records = {}
    for name, checks, kern, plain, bnd in (
            ("compute_volume_grids", checks_v, volumes, volumes_ref, bnd_v),
            ("build_viscosity_system", checks_s, system, system_ref, bnd_s)):
        times = _level_times(kern, plain, flush_buf.zero_, on_card, bnd)
        records[name] = (checks, {**{k: times[k] for k in keys},
                                  "library_ms": None}, bnd)
    del flush_buf
    return records


def _level_times(kern, plain, flush, on_card, bnd) -> dict:
    """A level's times: the kernel back to back and cold (device_ms; on the
    CPU, where the plain version runs, time_ms and no cold time), the plain
    version, and the bound `bnd` with the ratio of the cold time to it."""
    if on_card:
        ms, cold = device_ms(kern), device_ms(kern, flush)
    else:
        ms, cold = time_ms(kern, "cpu", batch_ms=5.0), None
    out = {"ms": ms, "ms_cold": cold,
           "plain_ms": time_ms(plain, "cuda" if on_card else "cpu",
                               batch_ms=5.0 if not on_card else 50.0),
           **bnd}
    out["cold_over_bound"] = (cold / bnd["bound_ms"] if cold is not None
                              else None)
    return out


def _times(kern, plain, library=None) -> dict:
    """The times of a record, taken while its inputs are alive: the
    kernel's, the plain version's and, where one PyTorch call computes the
    same function, that call's."""
    return {"ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library) if library else None}


def _exact(name, got, want) -> dict:
    return {"check": name, "ok": bool(torch.equal(got, want))}


# particles the revisit probes run over where the whole stream's (N, 128)
# values would not fit the card beside the images (256^3: 18 GB each)
PROBE_RUN = 1 << 23
# bytes the card must have free before the 108-lane image is checked too on
# a grid whose gather the JAX step splits (at 256^3: the columns 7.2 GB, the
# image 7.5, the rows twice 15.3, the plain version's W-major copy 7.2)
_ROOM_FOR_108 = 56e9


def _column_records(key_s, partial, grids, shape, gen) -> dict:
    """The records of K7-K10 for check_kernels: (checks, times, bound).

    K7 on the MAC column image of `grids` (2 grids per component), f32 and
    bf16, on the sorted keys `key_s` (every particle covered) and on
    `partial` = (keys in a random order, a partial coverage), torch.equal to
    gather_rows_ref: below 2^24 cells the 108-lane image at 108 and 54
    logical columns; from there on the 54-lane image of the first grids (the
    JAX step splits its gather there) and the 108-lane one only if the card
    has the room. K8 at F = 108 and F = 3, torch.equal to from_tile_major.
    K9 and K10 at F = 128 over the first PROBE_RUN sorted keys: K9 within
    probe.SCATTER_RTOL / SCATTER_ATOL of scatter_revisit_ref and bit-equal
    between two calls, K10 torch.equal to gather_revisit_ref. The library
    calls: for K7 one advanced index of the image by (tile, lane slice,
    cell), held torch.equal to the kernel's rows; for K8 the one
    contiguous() copy of the permuted view; index_add_ for K9 and
    index_select for K10."""
    dev = key_s.device
    n = key_s.shape[0]
    n_tiles = (shape[0] * shape[1] * shape[2]) // pp.W
    large = pp.large_grid(shape)
    gu, gv, gw = grids
    records = {}
    orders = (("sorted, all covered", key_s, None),
              ("random order, partly covered", *partial))
    distinct = int(torch.unique(key_s).numel())

    # K7
    checks, times, bnd = [], None, None
    t_idx, w_idx = (key_s // pp.W).long(), (key_s % pp.W).long()
    n_grids = 1 if large else 2
    lanes = (54 * n_grids, 54)[:n_grids]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        image = pp.build_mac_columns(gu[:n_grids], gv[:n_grids],
                                     gw[:n_grids], shape, dtype=dtype)
        for f in lanes:
            for label, keys, cov in orders:
                checks.append(_exact(
                    f"{tag} image, {f} columns, {label}",
                    pp.gather_rows(keys, cov, image, f),
                    pp.gather_rows_ref(keys, cov, image, f)))
            ms = time_ms(lambda: pp.gather_rows(key_s, None, image, f))
            checks[-1][f"ms_{tag}_{f}_sorted"] = ms
        if dtype == torch.float32:
            f = lanes[0]
            checks.append(_exact(
                f"the library call, {tag} image, {f} columns, sorted",
                image[t_idx, :f, w_idx],
                pp.gather_rows(key_s, None, image, f)))
            times = _times(lambda: pp.gather_rows(key_s, None, image, f),
                           lambda: pp.gather_rows_ref(key_s, None, image, f),
                           lambda: image[t_idx, :f, w_idx])
            bnd = bound(4 * n + distinct * f * 4 + n * f * 4, 0)
        del image
    if large:
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        if free >= _ROOM_FOR_108:
            image = pp.build_mac_columns(gu, gv, gw, shape)
            checks.append(_exact(
                "f32 image, 108 columns, sorted, all covered",
                pp.gather_rows(key_s, None, image, 108),
                pp.gather_rows_ref(key_s, None, image, 108)))
            checks[-1]["ms_f32_108_sorted"] = time_ms(
                lambda: pp.gather_rows(key_s, None, image, 108))
            del image
        else:
            checks.append({"check": "f32 image, 108 columns: left out, the "
                           f"card has {free} B free", "ok": True})
    records["gather_rows"] = (checks, times, bnd)
    del t_idx, w_idx

    # K8
    checks = []
    nt = pp.tile_counts(shape)
    for f in (3, 108):
        y = torch.randn((n_tiles, pp.W, f), generator=gen, device=dev)
        checks.append(_exact(f"F = {f}", pp.detile(y, shape),
                             pp.from_tile_major(y, shape)))
        tiles = y.reshape(*nt, *pp.TILE, f)
        times = _times(
            lambda: pp.detile(y, shape),
            lambda: pp.from_tile_major(y, shape),
            lambda: tiles.permute(0, 3, 1, 4, 2, 5, 6).contiguous())
        checks[-1][f"ms_F{f}"] = times["ms"]
        bnd = bound(2 * _nbytes(y), 0)
        del y, tiles
    records["detile"] = (checks, times, bnd)

    # K9 / K10
    f = probe.F
    run = min(n, PROBE_RUN)
    keys = key_s[:run].contiguous()
    idx = keys.long()
    covers = f"the first {run} of {n} sorted particles"
    vals = torch.randn((pp.n_chunks(run), pp.C, f), generator=gen,
                       device=dev)
    got = probe.scatter_revisit(keys, vals, n_tiles)
    checks = [
        _exact(f"two calls bit-equal, {covers}", got,
               probe.scatter_revisit(keys, vals, n_tiles)),
        compare("vs scatter_revisit_ref", got,
                probe.scatter_revisit_ref(keys, vals, n_tiles),
                probe.SCATTER_RTOL, probe.SCATTER_ATOL)]
    del got
    rows = vals.reshape(-1, f)[:run]
    times = _times(
        lambda: probe.scatter_revisit(keys, vals, n_tiles),
        lambda: probe.scatter_revisit_ref(keys, vals, n_tiles),
        lambda: torch.zeros((n_tiles * pp.W, f), device=dev).index_add_(
            0, idx, rows))
    records["scatter_revisit"] = (
        checks, times,
        bound(4 * run + run * f * 4 + n_tiles * pp.W * f * 4, 0))
    del vals, rows

    cols = torch.randn((n_tiles, pp.W, f), generator=gen, device=dev)
    checks = [_exact(f"exact, {covers}", probe.gather_revisit(keys, cols),
                     probe.gather_revisit_ref(keys, cols))]
    flat = cols.reshape(-1, f)
    times = _times(lambda: probe.gather_revisit(keys, cols),
                   lambda: probe.gather_revisit_ref(keys, cols),
                   lambda: torch.index_select(flat, 0, idx))
    records["gather_revisit"] = (
        checks, times,
        bound(4 * run + int(torch.unique(keys).numel()) * f * 4
              + pp.n_chunks(run) * pp.C * f * 4, 0))
    return records


def _proto_records(cfg: SimConfig, dev, gen) -> dict:
    """The records of K11 and K12 for check_kernels: (checks, times, bound),
    on the round-1 prototype's input at the grid's size: make_scene(res)
    (the bench pool, 8 per cell; at >= 2^24 cells its first PROBE_RUN
    particles), sorted by sort_particles, cap 16 (the prototype's), F = 128
    random columns. K11 bit-equal between two calls, its slot table
    torch.equal to tile_scatter_ref and its sums within rtol 1e-5 / atol
    1e-6 of their largest magnitude (the plain index_add_ adds with atomics
    in another order); no one PyTorch call computes its rows. K12
    torch.equal to tile_gather_ref, with index_select of the flat columns
    by the particles' keys as the library call."""
    res = cfg.isize
    pos, vel, dx, shape = proto.make_scene(res)
    if pp.large_grid(shape):
        pos, vel = pos[:PROBE_RUN], vel[:PROBE_RUN]
    n = pos.shape[0]
    cap, f = 16, probe.F
    payload, starts, spans = proto.sort_particles(
        torch.from_numpy(pos).to(dev), torch.from_numpy(vel).to(dev), dx,
        shape)
    del pos, vel
    n_blocks = proto.n_blocks_of(shape)
    nt = proto.tile_counts(shape)
    covers = f"make_scene({res}): {n} particles"
    records = {}

    def k11():
        return proto.tile_scatter(starts, payload, nt, dx, cap)

    def k11_plain():
        return proto.tile_scatter_ref(starts, payload, nt, dx, cap)

    got = k11()
    checks = [_exact(f"two calls bit-equal, {covers}", got, k11())]
    want = k11_plain()
    checks += [
        _exact("slot table exact", got[..., proto.N_SUM:],
               want[..., proto.N_SUM:]),
        compare("sums", got[..., :proto.N_SUM], want[..., :proto.N_SUM],
                1e-5, 1e-6 * _max_abs(want[..., :proto.N_SUM]))]
    del got, want
    records["tile_scatter"] = (
        checks, _times(k11, k11_plain),
        tile_scatter_bound(payload, starts, cap, n))

    n_chunks = spans.shape[0]
    lanes = payload[:, :n_chunks * proto.C]
    cols = torch.randn((n_blocks, proto.W, f), generator=gen, device=dev)
    flat = cols.reshape(-1, f)
    idx = payload[6, :n].to(torch.int64)
    got = proto.tile_gather(spans, lanes, cols)
    checks = [_exact(f"exact, {covers}", got,
                     proto.tile_gather_ref(spans, lanes, cols)),
              {"check": "pad rows zero", "ok": not bool(got[n:].any())},
              _exact("the library call on the particles' rows", got[:n],
                     torch.index_select(flat, 0, idx))]
    out_bytes = _nbytes(got)
    del got
    distinct = int(torch.unique(idx).numel())
    records["tile_gather"] = (
        checks,
        _times(lambda: proto.tile_gather(spans, lanes, cols),
               lambda: proto.tile_gather_ref(spans, lanes, cols),
               lambda: torch.index_select(flat, 0, idx)),
        bound(4 * n_chunks * proto.C + distinct * f * 4 + out_bytes, 0))
    return records


def run_proto(device, res: int = 128, log=print) -> dict:
    """The prototype's path: scripts/pallas_particle_proto.run as its
    command line runs it (both checks at 16^3, then the sort, K11, K12 and
    the two baselines timed at res^3). The launch counts are set to 0 just
    before and read just after. Fails if a check failed or, on the card,
    if K11 or K12 never launched."""
    dev = torch.device(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    result = proto.run(dev, res, log=lambda line: None)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    log(json.dumps(result))
    failures = [] if result["ok"] else [
        f"a check of the prototype failed: {result['checks']}"]
    if dev.type == "cuda":
        failures += [f"kernel {k} was never launched"
                     for k in PROTO_KERNELS if launches[k] == 0]
    return {"result": result, "launches": launches, "wall_s": wall,
            "path_kernels": list(PROTO_KERNELS), "failures": failures}


def unfused_gather_mac(px, py, pz, keys, grids_u, grids_v, grids_w, dx,
                       grid_shape, dtype=torch.float32, split: bool = False):
    """gather_mac's samples by the unfused route, its oracle in the JAX
    package: build_mac_columns (image of `dtype`) -> gather_rows ->
    combine_mac_samples -> (3*n_grids, N) f32, rows g*3 + comp as
    gather_mac's. `split` builds and gathers one 54-lane image per grid, as
    the JAX step does at >= 2^24 cells, instead of one image of all."""
    n_grids = len(grids_u)
    groups = ([slice(g, g + 1) for g in range(n_grids)] if split
              else [slice(0, n_grids)])
    out = []
    for sl in groups:
        count = len(grids_u[sl])
        cols = pp.build_mac_columns(grids_u[sl], grids_v[sl], grids_w[sl],
                                    grid_shape, dtype=dtype)
        rows = pp.gather_rows(keys, None, cols, 54 * count)
        del cols
        us, vs, ws = pp.combine_mac_samples(rows, px, py, pz, keys, dx,
                                            grid_shape, count)
        for g in range(count):
            out += [us[g], vs[g], ws[g]]
    return torch.stack(out)


def check_unfused_route(state, prev, cfg: SimConfig, log=print) -> dict:
    """On a state after a frame: the state's particles, sorted, sample its
    velocity grids (grid 0) and `prev` = the (u, v, w) of the frame before
    (grid 1, standing where the step has its FLIP-saved grids) by
    unfused_gather_mac (split at >= 2^24 cells) and by K2 gather_mac. Every
    one of the six sample rows must agree within rtol 1e-5 / atol 1e-6 (what
    the JAX package holds its fused kernel to against this route), with f32
    images, and with bf16 images against K2 on grids rounded to bf16. Also
    times the route's three stages and K2 on the f32 images."""
    shape, dx = cfg.grid_shape, cfg.dx
    split = pp.large_grid(shape)
    stream = pp.tiled_sort(state.pos, state.vel, dx, shape)
    px, py, pz = (stream.pos[:, a].contiguous() for a in range(3))
    key = stream.key
    grids = tuple([a, b] for a, b in zip((state.u, state.v, state.w), prev))
    checks = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        seen = [[g.to(dtype).float() for g in comp] for comp in grids]
        fused = pp.gather_mac(px, py, pz, key, *seen, dx, shape)
        route = unfused_gather_mac(px, py, pz, key, *grids, dx, shape,
                                   dtype=dtype, split=split)
        checks.append(compare(f"K7 + combine vs K2, {tag} image, max|sample| "
                              f"{_max_abs(fused):.4g}", route, fused, 1e-5,
                              1e-6))
        del seen, fused, route
    # one image as the route builds it: both grids, or one where it splits
    part = tuple(comp[:1] if split else comp for comp in grids)
    count = len(part[0])
    image = pp.build_mac_columns(*part, shape)
    rows = pp.gather_rows(key, None, image, 54 * count)
    rec = {
        "check": "unfused route", "grid": list(shape),
        "particles": int(key.shape[0]), "split": split,
        "images_per_sample": 2 // count,
        "image_ms": time_ms(lambda: pp.build_mac_columns(*part, shape)),
        "rows_ms": time_ms(
            lambda: pp.gather_rows(key, None, image, 54 * count)),
        "combine_ms": time_ms(lambda: pp.combine_mac_samples(
            rows, px, py, pz, key, dx, shape, count)),
        "gather_mac_ms": time_ms(
            lambda: pp.gather_mac(px, py, pz, key, *grids, dx, shape)),
        "ok": all(c["ok"] for c in checks), "checks": checks,
    }
    rec["route_ms"] = (2 // count) * (rec["image_ms"] + rec["rows_ms"]
                                      + rec["combine_ms"])
    log(json.dumps(rec))
    return rec


def run_hw_check(device, res: int = 128, particles: int = BENCH_PARTICLES,
                 large_res: int = 256, probe_n: int = 262_144,
                 log=print) -> dict:
    """The hardware-check path: the three modules of
    flipviscosity3d_torch/scripts in turn, as their command lines run them:
    pallas_hw_check at 32^3; gather_smem_check at `res`^3 with `particles`
    keys and at `large_res`^3 with 8 times as many; gather_perf_probe at
    `res`^3 with `probe_n` and with `particles` keys. The launch counts are
    set to 0 just before and read just after. Fails if a check inside a
    module failed or, on the card, if one of HW_CHECK_KERNELS never
    launched."""
    dev = torch.device(device)
    quiet = lambda line: None   # noqa: E731
    reset_launch_counts()
    t0 = time.perf_counter()
    modules = [
        pallas_hw_check.run(dev, log=quiet),
        gather_smem_check.run(dev, res, particles, log=quiet),
        gather_smem_check.run(dev, large_res, 8 * particles, log=quiet),
        probe.run(dev, res, probe_n, particles, log=quiet),
    ]
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for m in modules:
        log(json.dumps(m))
    failures = [f"{m['check']} at {m['res']}^3 failed" for m in modules
                if not m["ok"]]
    if dev.type == "cuda":
        failures += [f"kernel {k} was never launched"
                     for k in HW_CHECK_KERNELS if launches[k] == 0]
    return {"modules": modules, "launches": launches, "wall_s": wall,
            "path_kernels": list(HW_CHECK_KERNELS), "failures": failures}


_VCYCLE = ("mg_down", "mg_up")
# The scripts phase (run_scripts): the single-device measurement and
# readiness modules of flipviscosity3d_torch/scripts in the order they were
# ported, each as (module, its run() arguments at the JAX scripts'
# defaults, the kernels it must launch on the card). readiness512 runs at
# ISIZE 256 on 4 ranks: config 5's exact slabs, four of its eight.
SCRIPT_RUNS = (
    (profile_substep, dict(res=128), _VCYCLE),
    (pallas_engine_probe, dict(n=4_100_000, res=128),
     ("scatter_p2g_table", "gather_mac", "gather_mac_one_grid",
      "scatter_p2g_table_stale", "gather_rows8")),
    (mg_pallas_bench, dict(res=128, k=50), _VCYCLE),
    (mg_profile, dict(res=128, k=50), _VCYCLE),
    (solver_microbench, dict(res=64), _VCYCLE),
    (precond_experiment, dict(res=64), _VCYCLE),
    (particle_microbench, dict(res=128, np_=BENCH_PARTICLES), ()),
    (readiness256, dict(res=256, npart=500_000),
     ("scatter_p2g_table_folded", "gather_mac", "gather_mac_one_grid")
     + _VCYCLE),
    (readiness512, dict(res=512, npart=2_000_000, ndev=4, isize=256), ()),
)


def _script_name(module) -> str:
    return module.__name__.rsplit(".", 1)[-1]


def run_scripts(device, runs=SCRIPT_RUNS, log=print) -> dict:
    """The scripts phase: each module's run(device, **arguments) of `runs`
    in turn, its launch counts set to 0 just before and read just after,
    one line per module (its result, wall seconds and the counts it
    launched). A module fails if it raises, if its result is not ok, or, on
    the card, if one of its kernels never launched; the readiness modules
    also if a particle was lost or a value is not finite."""
    dev = torch.device(device)
    quiet = lambda line: None   # noqa: E731
    lines, failures = [], []
    total = {fn.__name__: 0 for fn, _, _ in KERNELS}
    t_all = time.perf_counter()
    for module, args, kernels in runs:
        name = _script_name(module)
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            result = module.run(dev, **args, log=quiet)
        except Exception:   # one module's fault must not hide the others'
            result = {"ok": False, "error": traceback.format_exc()}
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        for k, v in counts.items():
            total[k] += v
        line = {"module": name, "args": args, "wall_s": wall,
                "launches": {k: v for k, v in counts.items() if v},
                **result}
        log(json.dumps(line))
        lines.append(line)
        if not result["ok"]:
            failures.append(f"{name} failed: {result.get('error', '')}")
        if dev.type == "cuda":
            failures += [f"{name}: kernel {k} was never launched"
                         for k in kernels if counts[k] == 0]
        if name == "readiness512" and "alive" in result and (
                result["alive"] != args["npart"] or not result["finite"]):
            failures.append(f"{name} lost a particle or a position is not "
                            "finite")
        if name == "readiness256" and "com_y" in result and not (
                result["finite"] and math.isfinite(result["com_y"])):
            failures.append(f"{name} printed a value that is not finite")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"modules": lines, "launches": total,
            "wall_s": time.perf_counter() - t_all,
            "path_kernels": sorted({k for _, _, ks in runs for k in ks}),
            "failures": failures}


# ---------------------------------------------------------------------------
# the CLI's paths
# ---------------------------------------------------------------------------

class _Tee(io.StringIO):
    """Keeps what is written and passes it on to `stream`."""

    def __init__(self, stream):
        super().__init__()
        self._stream = stream

    def write(self, text):
        self._stream.write(text)
        return super().write(text)

    def flush(self):
        self._stream.flush()


def run_cli(argv) -> tuple:
    """cli.main(argv) in this process -> (its SceneRun, the JSON line of
    each frame as a dict, the set-up seconds it printed)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        run = cli.main(argv)
    lines = tee.getvalue().splitlines()
    frames = [json.loads(ln) for ln in lines if ln.startswith("{")]
    setup = [float(ln.split()[-2]) for ln in lines
             if ln.startswith("initialized:")]
    return run, frames, setup[0]


def write_scene(workdir, name: str, boundary, liquid, **spec) -> str:
    """Write the boundary and liquid meshes as PLY (save_ply) under
    `workdir` and a scene file `name`.json that names them, with the other
    scene keys `spec` -> the scene file's path. Exports and checkpoints go
    to `workdir`/`name`."""
    os.makedirs(workdir, exist_ok=True)
    paths = {}
    for part, mesh in (("boundary", boundary), ("liquid", liquid)):
        paths[part] = os.path.join(workdir, f"{name}_{part}.ply")
        tm.save_ply(paths[part], mesh)
    scene = os.path.join(workdir, name + ".json")
    with open(scene, "w") as f:
        json.dump({"boundary_mesh": paths["boundary"],
                   "liquid_meshes": [paths["liquid"]],
                   "output_dir": os.path.join(workdir, name), **spec}, f,
                  indent=1)
    return scene


def run_scene_path(device, workdir, name: str, res: int, frames: int,
                   dt: float = DT, lift: float = 0.0,
                   particle_engine: str | None = "pallas",
                   **overrides) -> dict:
    """The bench scene (lifted by `lift`, config `overrides`) through the
    scene CLI: the pool and a container one cell inside the domain (so
    the solid boundary stays the domain's own) are written as PLY files
    with a scene file, and cli.main runs one warm frame and `frames` timed
    frames of `dt` from them. The scene file's config names
    `particle_engine`, or no engine if it is None (the CLI then runs the
    default). The launch counts are set to 0 just before cli.main and read
    just after. Returns run_main_path's dict plus `run` (the SceneRun) and
    `engine` (the engine the run's config says)."""
    dev = torch.device(device)
    config = {"bucket_capacity": 16, **overrides}
    if particle_engine is not None:
        config["particle_engine"] = particle_engine
    scene = write_scene(
        workdir, name, box_mesh((1.0 / res,) * 3, (1.0 - 1.0 / res,) * 3),
        pool_mesh(res, lift), resolution=res, viscosity=5.0, dt=dt,
        frames=frames + 1, export="none", config=config)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    run, lines, setup_s = run_cli(["--scene", scene, "--device", dev.type])
    result = _path_result(run.sim, run.frames, run.frames[1:],
                          sum(ln["wall_s"] for ln in lines[1:]),
                          launch_counts(), dev, setup_s)
    result["run"] = run
    result["engine"] = run.sim.cfg.particle_engine
    return result


_CLI_INT_FIELDS = ("substeps", "pressure_iters", "viscosity_iters",
                   "liquid_cells", "bucket_overflow")


def run_cli64(device, workdir, resolution=None) -> dict:
    """The CLI at its default resolution (64; `resolution` overrides it for
    the CPU tests) on a sphere drop in an inverted cube, both from
    io/primitives, on the "pallas" engine: 4 frames with --export both
    --checkpoint-every 2, then a second run of 2 frames resumed from
    ckpt_0002.npz. Checks that frame
    2's PLY and OBJ exports read back to the checkpoint's positions (PLY
    exactly, OBJ to 1e-6), that the resumed run's lines repeat the first
    run's frames 2 and 3 in every integer field, and that the two final
    positions differ by at most 1e-5. The launch counts cover both runs."""
    dev = torch.device(device)
    scene = write_scene(workdir, "cli64",
                        primitives.cube((0.5, 0.5, 0.5), 0.9),
                        primitives.sphere((0.5, 0.6, 0.5), 0.2),
                        config={"particle_engine": "pallas"})
    base = ["--scene", scene, "--device", dev.type, "--export", "both"]
    if resolution is not None:
        base += ["--resolution", str(resolution)]
    out = os.path.join(workdir, "cli64")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    first, lines1, setup_s = run_cli(
        base + ["--frames", "4", "--checkpoint-every", "2"])
    ckpt = os.path.join(out, "ckpt_0002.npz")
    second, lines2, _ = run_cli(
        base + ["--frames", "2", "--resume", ckpt,
                "--output-dir", out + "_resumed"])
    launches = launch_counts()

    failures = []
    with np.load(ckpt) as data:
        saved = data["pos"]
    ply = tm.load_ply(os.path.join(out, "0002.ply")).vertices
    obj = tm.load_obj(os.path.join(out, "0002.obj")).vertices
    if not np.array_equal(ply, saved):
        failures.append("frame 2's PLY export differs from the checkpoint")
    obj_err = float(np.abs(obj - saved).max())
    if not obj_err <= 1e-6:
        failures.append(f"frame 2's OBJ export differs by {obj_err}")
    resumed_ply = tm.load_ply(os.path.join(out + "_resumed", "0000.ply"))
    if not np.array_equal(resumed_ply.vertices, saved):
        failures.append("the resumed run's first export differs from the "
                        "checkpoint")
    for a, b in zip(lines1[2:], lines2):
        for k in _CLI_INT_FIELDS:
            if a[k] != b[k]:
                failures.append(f"resumed frame {b['frame']}: {k} {b[k]} "
                                f"but {a[k]} in the first run")
    final_diff = float((first.sim.state.pos - second.sim.state.pos)
                       .abs().max())
    if not final_diff <= 1e-5:
        failures.append(f"final positions differ by {final_diff}")
    diags = first.frames + second.frames
    result = _path_result(first.sim, diags, diags,
                          sum(ln["wall_s"] for ln in lines1 + lines2),
                          launches, dev, setup_s)
    result.update(obj_max_abs_err=obj_err,
                  resumed_final_max_abs_diff=final_diff)
    result["failures"] = failures + result["failures"]
    return result


def profile_frames(res: int, frames: int, top: int = 25, dt: float = DT,
                   lift: float = 0.0, **overrides) -> dict:
    """Trace `frames` frames of `dt` of the bench scene (lifted by `lift`,
    config `overrides`) on the card after one warm frame (profile_sim)."""
    sim = bench_scene("cuda", res, lift, **overrides)
    sim.advance(dt)
    return profile_sim(sim, frames, top, dt)


def profile_sim(sim, frames: int, top: int = 25, dt: float = DT) -> dict:
    """Trace the next `frames` frames of `dt` of a simulation on the card
    with torch.profiler: wall time, device busy time, the `top` operators
    by device self time, and the frames' stages (_trace)."""
    return _trace(lambda: [sim.advance(dt) for _ in range(frames)], frames,
                  top)


def profile_sharded(res: int, frames: int = 1, n_slabs: int = SHARDED_SLABS,
                    engine: str = "pallas", top: int = 25,
                    dt: float = DT) -> dict:
    """profile_sim for the slab pipeline: the bench scene at res^3 in
    n_slabs slabs on a LocalGroup on the card, one warm frame, then
    `frames` frames traced."""
    from .parallel import shard_step as sh
    from .parallel.collectives import LocalGroup

    sim = bench_scene("cuda", res, particle_engine=engine)
    cfg, state = sim.cfg, sim.state
    spec = sh.make_spec(cfg, n_slabs, n_particles=int(state.pos.shape[0]))
    group = LocalGroup(n_slabs, "cuda")
    box = [sh.shard_simstate(state, cfg, spec, group)]
    del sim, state

    def advance():
        box[0], d = sh.advance_sharded(box[0], dt, cfg, spec, group)
        return d

    advance()
    return _trace(lambda: [advance() for _ in range(frames)], frames, top)


def _trace(run, frames: int, top: int) -> dict:
    """run() (-> the frames' StepDiagnostics) under torch.profiler on the
    card: wall time; device busy time, the union of the device operations'
    intervals in the Chrome trace (overlapping streams count once); the
    `top` operators by device self time; and the frames' stages summed by
    name (utils/trace.py; empty for the slab pipeline, which has none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        diags = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    chrome = data["traceEvents"] if isinstance(data, dict) else data
    busy_us = trace.device_busy_us(e for e in chrome if e.get("ph") == "X")
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    return {
        "frames": frames, "substeps": sum(d.substeps for d in diags),
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "top": [{"name": e.key[:90], "calls": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in events[:top]],
        "stages": trace.sum_stages(diags),
    }


# ---------------------------------------------------------------------------
# the slab pipeline (parallel/): the bench scene in slabs
# ---------------------------------------------------------------------------

def _sharded_kernels(cfg: SimConfig, spec) -> tuple:
    """The kernels a sharded substep under `cfg` launches once per slab:
    under "pallas" K5 (folded where a slab holds >= 2^24 cells), K2 of two
    grids and of one; none under "stream". The slab V-cycle's levels are
    halo'd stencils in plain torch; its gathered tail would run K3 / K4,
    but at the power-of-two grids of the paths it is a single level (8^3
    pressure, 5^3 viscosity blocks; slab_mg's docstring), solved by its
    dense inverse, so K3 / K4 are not among them."""
    if cfg.particle_engine != "pallas":
        return ()
    local = (spec.B + 2 * spec.H, cfg.jsize, cfg.ksize)
    k5 = SHARDED_KERNELS[0] + ("_folded" if pp.large_grid(local) else "")
    return (k5,) + SHARDED_KERNELS[1:]


def sharded_launches(kernels, d, n_slabs: int) -> dict:
    """The launches of each kernel that a viscous sharded frame with
    diagnostics `d` makes on the card: each of `kernels` once per slab and
    substep; the viscosity operator once per slab and viscosity iteration,
    and twice more per slab and substep (the build's RHS coupling and the
    warm start's residual); K14's volume kernel once per slab and substep
    and its assembly and RHS kernels, counted on build_viscosity_system,
    twice; no other kernel."""
    want = dict.fromkeys(launch_counts(), 0)
    for k in kernels:
        want[k] = n_slabs * d.substeps
    want["viscosity_operator"] = n_slabs * (d.viscosity_iterations
                                            + 2 * d.substeps)
    want["compute_volume_grids"] = n_slabs * d.substeps
    want["build_viscosity_system"] = 2 * n_slabs * d.substeps
    return want


def _sharded_frame_line(d, launches, counts, substeps_s=None) -> dict:
    line = {k: getattr(d, k) for k in (
        "substeps", "pressure_iterations", "viscosity_iterations",
        "pressure_residual", "pressure_tolerance", "viscosity_residual",
        "viscosity_tolerance", "bucket_overflow", "liquid_cells",
        "max_velocity", "uncovered_pass_a", "uncovered_pass_b", "migrated",
        "migration_lost")}
    line["uncovered_per_slab"] = [list(u) for u in d.slab_uncovered]
    line["launches_per_substep"] = {
        k: v / max(d.substeps, 1) for k, v in launches.items() if v}
    line["collectives_per_substep"] = {
        k: {"calls": c["calls"] / max(d.substeps, 1),
            "bytes": c["bytes"] / max(d.substeps, 1)}
        for k, c in counts.items()}
    if substeps_s is not None:
        line["substeps_per_s"] = substeps_s
    return line


def compare_sharded(ss, spec, sdiag, single_state, diag, atol=SHARDED_ATOL):
    """The sharded frame (ss, sdiag) against the single-device one
    (single_state, diag) from the same state: equal substeps, iterations
    within 1 per solve, sorted positions and the owned rows of u within
    `atol` -> (failures, max differences)."""
    from .parallel import shard_step as sh

    failures = []
    if sdiag.substeps != diag.substeps:
        failures.append(f"substeps {sdiag.substeps} against the single "
                        f"device's {diag.substeps}")
    for solve in ("pressure_iterations", "viscosity_iterations"):
        a, b = getattr(sdiag, solve), getattr(diag, solve)
        if abs(a - b) > 1:
            failures.append(f"{solve} {a} against the single device's {b}")
    pos, _ = sh.gather_particles(ss)
    want = single_state.pos.cpu().numpy()
    diffs = {}
    if pos.shape != want.shape:
        failures.append(f"{pos.shape[0]} particles against "
                        f"{want.shape[0]}")
    else:
        diffs["pos"] = float(np.abs(np.sort(pos, axis=0)
                                    - np.sort(want, axis=0)).max())
    diffs["u"] = float(np.abs(sh.gather_grid_u(ss, spec)
                              - single_state.u.cpu().numpy()).max())
    failures += [f"max |{k} - single device| = {v} > {atol}"
                 for k, v in diffs.items() if not v <= atol]
    return failures, diffs


def run_sharded_path(device, res: int, frames: int,
                     n_slabs: int = SHARDED_SLABS, engine: str = "pallas",
                     dt: float = DT, compare: bool = True, log=print,
                     **overrides) -> dict:
    """The bench scene at res^3 in n_slabs slabs through advance_sharded on
    a LocalGroup of n_slabs rank-threads on `device`: one warm frame, then
    `frames` timed frames of `dt`. With `compare` the single-device advance
    first runs the warm frame from the same state, and the sharded warm
    frame is held against it (compare_sharded). Every frame must keep its
    residuals under their tolerances, lose no particle to migration and,
    on the card, launch each of the path's kernels (_sharded_kernels) once
    per slab and substep, the viscosity operator as sharded_launches counts
    and no other kernel. The launch and collective
    counts are set to 0 just before the first sharded frame; each frame's
    line carries its own (per substep). Returns the frames' lines, the
    totals, substeps/s over the timed frames, peak memory and `failures`."""
    from .core import step as tstep
    from .parallel import shard_step as sh
    from .parallel.collectives import LocalGroup

    dev = torch.device(device)
    t0 = time.perf_counter()
    sim = bench_scene(dev, res, particle_engine=engine, **overrides)
    cfg, state = sim.cfg, sim.state
    del sim
    n = int(state.pos.shape[0])
    failures, diffs = [], {}
    single = None
    if compare:
        single = tstep.advance(state, dt, cfg)
    spec = sh.make_spec(cfg, n_slabs, n_particles=n)
    group = LocalGroup(n_slabs, dev)
    ss = sh.shard_simstate(state, cfg, spec, group)
    del state
    _sync(dev)
    setup_s = time.perf_counter() - t0
    log(json.dumps({"scene": f"{res}^3", "particles": n, "slabs": n_slabs,
                    "spec": spec._asdict(), "engine": engine,
                    "device": str(dev), "dt": dt}))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels = _sharded_kernels(cfg, spec)
    lines, totals = [], dict.fromkeys(launch_counts(), 0)
    wall = 0.0
    for frame in range(frames + 1):
        reset_launch_counts()
        group.reset_counts()
        _sync(dev)
        t1 = time.perf_counter()
        ss, d = sh.advance_sharded(ss, dt, cfg, spec, group)
        _sync(dev)
        secs = time.perf_counter() - t1
        if frame:
            wall += secs
        launches = launch_counts()
        line = _sharded_frame_line(d, launches, group.counts(),
                                   d.substeps / secs)
        line.update(frame=frame, warm=frame == 0)
        if frame == 0 and single is not None:
            f, diffs = compare_sharded(ss, spec, d, *single)
            failures += [f"warm frame: {x}" for x in f]
            line["vs_single_device"] = dict(
                diffs, substeps=single[1].substeps,
                pressure_iterations=single[1].pressure_iterations,
                viscosity_iterations=single[1].viscosity_iterations)
            single = None
        log(json.dumps(line))
        lines.append(line)
        for k, v in launches.items():
            totals[k] += v
        for solve in ("pressure", "viscosity"):
            res_, tol = (getattr(d, solve + "_residual"),
                         getattr(d, solve + "_tolerance"))
            if not res_ <= tol:
                failures.append(f"frame {frame}: {solve} residual {res_} "
                                f"above its tolerance {tol}")
        if d.migration_lost:
            failures.append(f"frame {frame}: {d.migration_lost} particles "
                            "lost to migration")
        if dev.type == "cuda":
            want = sharded_launches(kernels, d, n_slabs)
            failures += [f"frame {frame}: kernel {k} launched {v} times, "
                         f"not {want[k]}"
                         for k, v in launches.items() if v != want[k]]
    pos, _ = sh.gather_particles(ss)
    if pos.shape[0] != n:
        failures.append(f"{pos.shape[0]} particles at the end, not {n}")
    if not np.isfinite(pos).all():
        failures.append("non-finite particle positions")
    timed = sum(ln["substeps"] for ln in lines[1:])
    return {
        "particles": n, "slabs": n_slabs, "engine": engine,
        "frames": lines, "timed_frames": frames, "substeps": timed,
        "vs_single_device": diffs,
        "substeps_per_s": timed / wall if wall else None,
        "peak_bytes": (torch.cuda.max_memory_allocated()
                       if dev.type == "cuda" else None),
        "launches": totals, "path_kernels": list(kernels),
        "setup_s": setup_s, "failures": failures, "state": ss, "spec": spec,
    }


def run_sharded_dist(device, res: int, store_path: str, dt: float = DT,
                     engine: str = "pallas", log=print) -> dict:
    """One frame of the bench scene at res^3 through advance_sharded on a
    DistGroup of world size 1 (NCCL on the card, gloo on the CPU; a
    FileStore at `store_path`), held against a LocalGroup of one rank from
    the same state: integer diagnostics equal, the largest float
    differences of positions and u reported (and within SHARDED_ATOL)."""
    import torch.distributed as dist

    from .parallel import shard_step as sh
    from .parallel.collectives import DistGroup, LocalGroup

    dev = torch.device(device)
    sim = bench_scene(dev, res, particle_engine=engine)
    cfg, state = sim.cfg, sim.state
    del sim
    spec = sh.make_spec(cfg, 1, n_particles=int(state.pos.shape[0]))
    out = {}
    if os.path.exists(store_path):
        os.remove(store_path)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(store_path, 1), rank=0, world_size=1)
    try:
        for name, group in (("dist", DistGroup(dev)),
                            ("local", LocalGroup(1, dev))):
            ss = sh.shard_simstate(state, cfg, spec, group)
            ss, d = sh.advance_sharded(ss, dt, cfg, spec, group)
            out[name] = (ss, d, group.counts())
            log(json.dumps({"group": name, **_sharded_frame_line(
                d, {}, group.counts())}))
    finally:
        dist.destroy_process_group()
    (ss_d, d_d, c_d), (ss_l, d_l, c_l) = out["dist"], out["local"]
    failures = []
    ints = ("substeps", "pressure_iterations", "viscosity_iterations",
            "bucket_overflow", "liquid_cells", "migrated", "migration_lost",
            "uncovered_pass_a", "uncovered_pass_b")
    for k in ints:
        if getattr(d_d, k) != getattr(d_l, k):
            failures.append(f"{k}: DistGroup {getattr(d_d, k)}, LocalGroup "
                            f"{getattr(d_l, k)}")
    if c_d != c_l:
        failures.append(f"collectives differ: {c_d} against {c_l}")
    diffs = {
        "pos": float((ss_d.pos - ss_l.pos).abs().max()),
        "u": float((ss_d.u - ss_l.u).abs().max()),
        "alive_equal": bool(torch.equal(ss_d.alive, ss_l.alive)),
    }
    if not diffs["alive_equal"]:
        failures.append("the two groups keep different particles alive")
    failures += [f"max |{k}| difference {diffs[k]} > {SHARDED_ATOL}"
                 for k in ("pos", "u") if not diffs[k] <= SHARDED_ATOL]
    return {"diffs": diffs, "substeps": d_d.substeps,
            "iterations": [d_d.pressure_iterations,
                           d_d.viscosity_iterations],
            "failures": failures}


# ---------------------------------------------------------------------------
# repeatability, the placed state, the dry run, the blitz
# ---------------------------------------------------------------------------

_INT_DIAGS = ("substeps", "pressure_iterations", "viscosity_iterations",
              "bucket_overflow", "liquid_cells", "stale_substeps",
              "uncovered_pass_a", "uncovered_pass_b", "uncovered_pushback")


def state_diffs(a, b) -> list:
    """The SimState fields (solid ones as solid.<name>) where a and b are
    not torch.equal."""
    from .core.state import _SOLID_FIELDS, _STATE_FIELDS

    out = [k for k in _STATE_FIELDS
           if not torch.equal(getattr(a, k), getattr(b, k))]
    return out + [f"solid.{k}" for k in _SOLID_FIELDS
                  if not torch.equal(getattr(a.solid, k),
                                     getattr(b.solid, k))]


def _int_diag_diffs(a, b, names=_INT_DIAGS) -> list:
    return [f"{k} {getattr(a, k)} against {getattr(b, k)}" for k in names
            if getattr(a, k) != getattr(b, k)]


def segment_reduce_index_add(stream, sums, mins, min_default):
    """The stream engine's segment_reduce as it was before its sums were
    made repeatable: one (N, S) index_add_ into a table with a guard row
    (atomics on the card, so each cell's order of addition changes from
    run to run). Kept to time the repair against, never on a path."""
    from .ops.stream import segment_reduce

    n_cells = stream.counts.shape[0]
    out = torch.zeros((n_cells + 1, len(sums)), device=stream.key.device)
    out.index_add_(0, stream.key, torch.stack(list(sums), dim=-1))
    _, min_cells = segment_reduce(stream, [], mins, min_default)
    return list(out[:n_cells].unbind(dim=1)), min_cells


@contextlib.contextmanager
def _index_add_sums():
    from .ops import stream_transfers

    kept = stream_transfers.segment_reduce
    stream_transfers.segment_reduce = segment_reduce_index_add
    try:
        yield
    finally:
        stream_transfers.segment_reduce = kept


def _frames_from(state, cfg, frames: int, dev, dt: float = DT):
    """One warm frame, then `frames` timed frames of core.step.advance from
    `state` -> (final state, every frame's diagnostics, timed substeps/s)."""
    from .core import step as tstep

    diags = []
    wall = 0.0
    for frame in range(frames + 1):
        _sync(dev)
        t0 = time.perf_counter()
        state, d = tstep.advance(state, dt, cfg)
        _sync(dev)
        if frame:
            wall += time.perf_counter() - t0
        diags.append(d)
    timed = sum(d.substeps for d in diags[1:])
    return state, diags, timed / wall if wall else None


def _sums_times(state, cfg, dev, columns: int = 108) -> dict:
    """CUDA-event ms of segment_reduce's sums and of the index_add_ form on
    the stream of `state`'s particles with `columns` random sums a
    particle (p2g_sdf_stream's 3 x 18 x 2)."""
    from .ops.stream import segment_reduce, stream_sort

    stream = stream_sort(state.pos, [], cfg.dx, cfg.grid_shape)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sums = list(torch.randn((columns, state.pos.shape[0]), generator=gen,
                            device=dev).unbind(0))
    return {"rows": int(state.pos.shape[0]), "columns": columns,
            "segment_ms": time_ms(lambda: segment_reduce(stream, sums, [],
                                                         0.0), dev),
            "index_add_ms": time_ms(lambda: segment_reduce_index_add(
                stream, sums, [], 0.0), dev)}


def run_stream_repeat(device, res: int, frames: int = 2,
                      sharded_frames: int = 1,
                      n_slabs: int = SHARDED_SLABS, log=print) -> dict:
    """The "stream" engine's bench scene run four times from one state, one
    warm frame and `frames` timed ones each, in turns: with the sums of
    segment_reduce_index_add (the form before the repair), twice with
    segment_reduce's, once more with index_add_; then the slab pipeline on
    "stream" (n_slabs rank-threads) twice from one state for
    `sharded_frames` frames. Fails unless the two runs of each with
    segment_reduce give torch.equal states and equal integer diagnostics,
    frame by frame. On the card it also times the two forms of the sums
    alone (_sums_times)."""
    from .parallel import shard_step as sh
    from .parallel.collectives import LocalGroup

    dev = torch.device(device)
    sim = bench_scene(dev, res, particle_engine="stream")
    cfg, state0 = sim.cfg, sim.state
    del sim
    failures = []
    runs, before = [], []
    for label in ("index_add", "first", "second", "index_add"):
        if label == "index_add":
            with _index_add_sums():
                before.append(_frames_from(state0, cfg, frames, dev))
            out = before[-1]
        else:
            runs.append(_frames_from(state0, cfg, frames, dev))
            out = runs[-1]
        log(json.dumps({"stream_run": label, "substeps_per_s": out[2],
                        "frames": [d.as_dict() for d in out[1]]}))
    diffs = state_diffs(runs[0][0], runs[1][0])
    if diffs:
        failures.append(f"stream: the two runs differ in {diffs}")
    for i, (a, b) in enumerate(zip(runs[0][1], runs[1][1])):
        failures += [f"stream frame {i}: {x}" for x in _int_diag_diffs(a, b)]
    result = {
        "particles": int(state0.pos.shape[0]),
        "timed_frames": frames,
        "substeps_per_s": [r[2] for r in runs],
        "substeps_per_s_index_add": [r[2] for r in before],
        "index_add_runs_differ_in": [state_diffs(runs[0][0], r[0])
                                     for r in before],
        "liquid_cells": [[d.liquid_cells for d in r[1]]
                         for r in (*runs, *before)],
    }
    del runs, before
    if dev.type == "cuda":
        result["sums"] = _sums_times(state0, cfg, dev)
        torch.cuda.empty_cache()

    spec = sh.make_spec(cfg, n_slabs, n_particles=result["particles"])
    outs = []
    for _ in range(2):
        group = LocalGroup(n_slabs, dev)
        ss = sh.shard_simstate(state0, cfg, spec, group)
        ds = []
        for _ in range(sharded_frames):
            ss, d = sh.advance_sharded(ss, DT, cfg, spec, group)
            ds.append(d)
        outs.append((ss, ds))
    (sa, da), (sb, db) = outs
    names = ("pos", "vel", "alive", "u", "v", "w")
    diffs = [k for k in names if not torch.equal(getattr(sa, k),
                                                 getattr(sb, k))]
    if diffs:
        failures.append(f"sharded_stream: the two runs differ in {diffs}")
    for i, (a, b) in enumerate(zip(da, db)):
        failures += [f"sharded_stream frame {i}: {x}" for x in
                     _int_diag_diffs(a, b, _INT_DIAGS[:6] + (
                         "migrated", "migration_lost"))]
        if a.slab_uncovered != b.slab_uncovered:
            failures.append(f"sharded_stream frame {i}: uncovered per slab "
                            f"{a.slab_uncovered} against {b.slab_uncovered}")
    result["sharded"] = {"slabs": n_slabs, "frames": sharded_frames,
                         "substeps": [d.substeps for d in da],
                         "liquid_cells": [[d.liquid_cells for d in ds]
                                          for ds in (da, db)]}
    result["failures"] = failures
    return result


def run_placed_path(device, res: int, frames: int = 1, n_ranks: int = 4,
                    log=print) -> dict:
    """The bench scene at res^3, its particles trimmed to a multiple of
    n_ranks, placed on a LocalGroup of n_ranks rank-threads
    (parallel/sharding.shard_state) and advanced by
    advance_placed, one warm frame and `frames` timed ones; each frame is
    held against core.step.advance from the same state (torch.equal state,
    equal diagnostics). The launch counts cover the placed frames only
    (set to 0 before each, read after). Fails on a difference or, on the
    card, if a kernel of the bench path never launched."""
    from .core import step as tstep
    from .parallel.collectives import LocalGroup
    from .parallel.sharding import advance_placed, shard_state, unplace

    dev = torch.device(device)
    sim = bench_scene(dev, res)
    cfg, single = sim.cfg, sim.state
    del sim
    # shard_state refuses a particle count the ranks do not divide, as
    # jax.device_put does; trim as tests/test_sharding.py does
    keep = single.pos.shape[0] // n_ranks * n_ranks
    single = single.replace(pos=single.pos[:keep], vel=single.vel[:keep])
    group = LocalGroup(n_ranks, dev)
    placed, placements = shard_state(single, group, cfg)
    kinds = {}
    for k, v in dataclasses.asdict(placements).items():
        for name, p in (v.items() if k == "solid" else ((k, v),)):
            kinds.setdefault(p[0], []).append(name)
    failures, lines = [], []
    totals = dict.fromkeys(launch_counts(), 0)
    wall = substeps = 0
    if dev.type == "cuda":   # the peak of both runs' frames, nothing before
        torch.cuda.reset_peak_memory_stats()
    for frame in range(frames + 1):
        single, d1 = tstep.advance(single, DT, cfg)
        reset_launch_counts()
        group.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        placed, d2 = advance_placed(placed, placements, DT, cfg, group)
        _sync(dev)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] += v
        if frame:
            wall += secs
            substeps += d2.substeps
        diffs = state_diffs(unplace(placed, placements), single)
        if diffs:
            failures.append(f"frame {frame}: differs from the single "
                            f"device in {diffs}")
        if d1 != d2:
            failures.append(f"frame {frame}: diagnostics {d2} against the "
                            f"single device's {d1}")
        line = {"frame": frame, "warm": frame == 0, "substeps": d2.substeps,
                "pressure_iterations": d2.pressure_iterations,
                "viscosity_iterations": d2.viscosity_iterations,
                "equal_to_single_device": not diffs and d1 == d2,
                "seconds": secs,
                "collectives": group.counts(),
                "launches": {k: v for k, v in counts.items() if v}}
        log(json.dumps(line))
        lines.append(line)
    kernels = path_kernels(cfg)
    if dev.type == "cuda":
        failures += [f"kernel {k} was never launched" for k in kernels
                     if totals[k] == 0]
    return {"particles": int(single.pos.shape[0]), "ranks": n_ranks,
            "placements": kinds, "frames": lines, "timed_frames": frames,
            "substeps_per_s": substeps / wall if wall else None,
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if dev.type == "cuda" else None),
            "launches": totals, "path_kernels": kernels,
            "failures": failures}


def run_dryrun(device, n_devices: int = 4, log=print) -> dict:
    """graft_entry.dryrun_multichip(n_devices) and entry()'s fn once."""
    from . import graft_entry

    dev = torch.device(device)
    failures = []
    t0 = time.perf_counter()
    try:
        out = graft_entry.dryrun_multichip(n_devices, dev, log=log)
    except Exception:   # reported with the other phases' failures
        out = {"error": traceback.format_exc()}
        failures.append(f"dryrun_multichip raised: {out['error']}")
    fn, (state, dt) = graft_entry.entry(dev)
    pos, u, substeps = fn(state, dt)
    out["entry"] = {"particles": int(pos.shape[0]), "u": list(u.shape),
                    "substeps": substeps,
                    "finite": bool(torch.isfinite(pos).all())}
    if not (substeps >= 1 and out["entry"]["finite"]):
        failures.append(f"entry()'s frame: {out['entry']}")
    out["wall_s"] = time.perf_counter() - t0
    out["failures"] = failures
    return out
