#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name and power limit from nvidia-smi), the torch and
   CUDA versions and the device count; exits non-zero without a CUDA device
   or without the flipviscosity3d_torch package beside this script.
2. Builds the CUDA kernels from flipviscosity3d_torch/csrc (one nvcc per
   source, all started together, sm_90a) and prints the build time and
   ptxas' register / spill report.
3. Holds each of the seventeen kernels against its plain PyTorch version
   on the card, in nineteen records (K2's one-grid launches, pass B's, have
   their own: gather_mac_one_grid; K14 has one per wrapper), at the bench
   scene's shapes (128^3 grid, ~4.1M particles; K1 at pallas_split_terms 3
   (exact products), 1 and 2 (the JAX package's bf16 splits), K2
   torch.equal at each of them with two grids at the particles and one
   grid at midpoints, some outside the domain, K5 at each of them too;
   K3 mg_down and K4 mg_up torch.equal at every level of the pressure and
   the viscosity hierarchy, with bf16 and f32 operators, one line per level
   with its times, back to back and with L2 flushed, and its bound;
   K5 and K6 on a fully covered falling order and on a partly covered
   random one; K1 and K5 in both layouts of their sums, the K-folded one
   also against the unfolded kernels; K7 gather_rows at 108 and 54 columns
   of an f32 and a bf16 image, sorted and in a random, partly covered
   order; K8 detile at F = 108 and 3; the revisit probes K9 and K10 at F =
   128; the prototype's K11 tile_scatter and K12 tile_gather on its own
   128^3 pool of 4,456,448 particles, cap 16, F = 128; K5, K2 and
   gather_mac_one_grid once more at the slab pipeline's inputs: an inner
   slab of the 4-slab cut, its local grid of B + 2H = 48 rows, its
   key-sorted stream with the dead rows of its capacity, at each split-terms
   setting; K13 viscosity_operator torch.equal on a random premasked
   operator at the grid's face shapes, with and without its diagonal; K14
   compute_volume_grids and build_viscosity_system torch.equal to their
   plain versions on the bench pool's liquid, each timed back to back and
   with L2 flushed beside its bound; K15 liquid_sdf_from_table
   torch.equal to table_fields and liquid_sdf_from_particles on the table
   K1 writes for the scene, with and without finalize, timed back to back
   and with L2 flushed beside its bound (each cell's occupied slots and
   its first empty one, the solid phi and phi, once) and the bound of the
   whole table read once (table_bound_ms); K15
   once more on the slab's K5 table), and
   times the kernel, the plain version and, where one exists, the one
   PyTorch call that computes the same function (for K7 one advanced
   index of the image, for K2 grid_sample per component, with its
   difference from K2); states each kernel's bound. Then advances that
   scene by two frames and holds the unfused route (build_mac_columns ->
   K7 -> combine_mac_samples) against K2 gather_mac on its particles and
   grids, with f32 and with bf16 images.
4. Drives three main paths of the "pallas" engine through
   FluidSimulation() on the card, each with the launch counts set to 0
   just before it and read just after:
   - "bench": the bench scene under BENCH_DEFAULT's engine, "pallas", with
     its default variants (pass A "sort", pass B "plan", pushback
     "gather"), one warm frame and 3 frames of dt = 0.01;
   - "stale": the same pool lifted by 0.43 in y, so that it falls, under
     pass A "stale", pass B "plan" and pushback "kernel", one warm frame
     and 3 frames of dt = 0.04 (several substeps per frame, so that stale
     substeps occur);
   - "bench_sort": the bench run with pass B "sort" (a re-sort by
     midpoint key instead of the midpoint plan);
   - "bench_terms2": the bench run under pallas_split_terms 2, one warm
     frame and 2 frames, beside the first frames of "bench" (substeps,
     iterations, max|u|); fails if its max|u| equals bench's in every
     frame (the rounding would then not act);
   printing each frame's diagnostics (substeps, stale substeps, overflow,
   iterations, residuals and tolerances), substeps/s, peak memory and the
   launch counts, in all and per substep (over the warm frame's substeps
   too). A path fails if one of its kernels was never launched or
   a residual missed its tolerance. Then the bench run on the JAX
   package's two other engines, one warm frame and 3 timed each:
   - "table": particle_engine "table" (the JAX default), whose substeps
     launch only the V-cycle's kernels (K3, K4) and must launch them;
   - "stream": particle_engine "stream", the same;
   then three more:
   - "hw_check": the three hardware checks of flipviscosity3d_torch/scripts
     in turn (pallas_hw_check at 32^3; gather_smem_check at 128^3 with
     4,111,806 keys and at 256^3 with 8 times as many; gather_perf_probe at
     262,144 and 4,111,806 keys), one JSON line per module; fails if a check
     inside failed or K7, K8, K9 or K10 never launched;
   - "proto": the round-1 prototype module
     (flipviscosity3d_torch/scripts/pallas_particle_proto.py) as its command
     line runs it: its checks at 16^3, then the sort, K11, K12 and its two
     PyTorch baselines timed at 128^3; fails if a check failed or K11 or
     K12 never launched;
   - "scripts": the single-device measurement and readiness modules of
     flipviscosity3d_torch/scripts, each run() at the JAX scripts' defaults
     (smoke.SCRIPT_RUNS), one JSON line per module with the launch counts
     set to 0 just before it and read just after: profile_substep (128^3),
     pallas_engine_probe (128^3, 4,100,000 particles), mg_pallas_bench and
     mg_profile (128^3, chains of SCRIPT_K = 20, not 50), solver_microbench and
     precond_experiment (64^3), particle_microbench (128^3, 4,111,806
     particles), readiness256 (256^3, 500,000 particles) and readiness512
     (RES 512, ISIZE 256 on 4 slab ranks: config 5's exact slab shape);
     fails if a module raised or is not ok, if a kernel the module must
     launch (K1, K15, K2, its one-grid form, K5, K6 in the engine probe; the
     folded K1, K2, its one-grid form, K3 and K4 in readiness256; K3 and
     K4 in the V-cycle and solver modules and profile_substep's full
     advance) never launched, or if a readiness module lost a particle or
     printed a value that is not finite;
   - "bench_bf16": the bench run again under pallas_gather_dtype "bf16";
     fails unless its residuals hold and its final positions differ from
     those of "bench", the same run under "f32";
   - "stream_repeat" (smoke.run_stream_repeat): the bench scene on the
     "stream" engine twice from one state, one warm and 2 timed frames
     each, each run's substeps/s printed; then the slab pipeline on
     "stream" in 4 slabs twice from one state, 1 frame each; fails unless
     the two runs of each are torch.equal (positions, velocities, u, v,
     w; alive per slab) with equal integer diagnostics;
   - "placed" (smoke.run_placed_path): the bench scene, its particles
     trimmed to 4,111,260 (shard_state refuses a count that 4 does not
     divide, as jax.device_put does), placed on a LocalGroup of 4
     rank-threads (parallel/sharding.shard_state: the 128 i-rows split,
     the 129-row grids replicated, the particles split) and advanced by
     advance_placed, one warm and one timed frame,
     each torch.equal to the single-device advance from the same state
     with equal diagnostics; fails otherwise or if K1-K4 never launched in
     the placed frames;
   - "dryrun" (smoke.run_dryrun): graft_entry.dryrun_multichip(4) (the
     slab pipeline at 24^3 in 4 slabs with a +x drift, which must migrate
     particles and lose none, then the placed step at 16^3) and
     graft_entry.entry()'s frame once;
   - "hw_blitz": scripts/hw_blitz.py at 64^3 with 1 timed bench frame,
     every step (the kernel gate, the devices, the engine probe, the six
     pallas bench variants, the solver microbench, bench on "table", the
     winner); fails if a step failed, which on the card includes a step
     whose kernels did not launch (K1, K7, K8 in the gate; K1, K2, K5, K6
     in the probe; K1-K4 in 3, 3a, 3e, 3f; K1-K4 and K6 in 3b; K5 and
     K2-K4 in 3c; K3, K4 in 3d and 4).
   Then the slab pipeline (flipviscosity3d_torch/parallel) on the bench
   scene in 4 slabs (B = 32, H = 8), MG-PCG for both solves, through
   advance_sharded on a LocalGroup of 4 rank-threads on the card, each
   frame's line with its substeps, iterations, residuals, overflow, liquid
   cells, migration, uncovered particles per slab, launches and
   collectives per substep, the path's line with substeps/s beside the
   "bench" run's and peak memory (smoke.run_sharded_path):
   - "sharded": engine "pallas", one warm frame and 2 frames of dt = 0.01;
     the warm frame is held against the single-device advance from the
     same state (equal substeps, iterations within 1 per solve, sorted
     positions and the owned rows of u within 5e-4); every frame must keep
     its residuals under their tolerances, lose no particle to migration,
     and launch K5 scatter_p2g_table_stale, K15 liquid_sdf_from_table, K2
     gather_mac and gather_mac_one_grid once per slab and substep and no
     other kernel
     (the V-cycle's gathered tail would run K3 / K4, but at these grids it
     is a single level, solved by its dense inverse);
   - "sharded_stream": the same on engine "stream", 1 frame, which must
     launch no kernel at all;
   - "sharded_dist": one frame on a DistGroup of world size 1 over NCCL (a
     FileStore under build/) against a LocalGroup of one rank from the
     same state: integer diagnostics and collective counts equal.
5. Drives three paths through the scene CLI (flipviscosity3d_torch.cli),
   from mesh and scene files that it writes under build/smoke_scenes:
   - "cli64": the CLI at its default resolution of 64, a sphere drop in an
     inverted cube, 4 frames with PLY and OBJ exports and a checkpoint
     every 2 frames, then a second run resumed from the checkpoint, which
     must repeat the first run's last two frames;
   - "bench256": the bench scene at 256^3 (~35.5M particles), one warm frame
     and 3 frames of dt = 0.01; at this size the scatter folds its sums
     and the face combine runs in slabs, so the path fails unless the
     folded K1 ran and the unfolded K1 did not. On its final state step 3
     is repeated at the 256^3 shapes: all nineteen kernel records against
     their plain versions (257^3 levels, ~35.5M particles, the slab checks
     on a local grid of 80 rows; the plain scatters
     add their values in 16 runs of particles, to fit the card; K7 on the
     54-lane image, as the JAX step splits its gather there, and on the
     108-lane one if the card has the room; K9 and K10 over the first 2^23
     particles; K11 and K12 over the first 2^23 particles of the
     prototype's 256^3 pool), timed there, and the unfused route against
     K2 again;
   - "stale256": the lifted pool at 256^3 under stale / plan / kernel, one
     warm frame and 2 frames of dt = 0.04; fails unless the folded K5 and
     K6 ran;
   - "table256": the bench scene at 256^3 from a scene file whose config
     names no particle engine and a bucket_capacity of 12 (what
     scenes/highres_bunny.json gives, the pool standing in for its mesh),
     one warm frame and 1 frame of dt = 0.01; fails unless the run's
     config says "table" (the default) and K3 and K4 ran;
   - "sharded256": the bench scene at 256^3 in 4 slabs on "pallas" through
     advance_sharded, one warm frame and 1 frame, with the checks of
     "sharded" but the single-device comparison; prints its peak memory.
Cuts made to keep the run under 500 s once the scripts phase (~180 s) came
in: the V-cycle modules' chains there 50 -> 20 (SCRIPT_K), then timed
frames of the earlier paths: the 128^3 paths (bench, stale, bench_sort,
table, stream, bench_bf16) 5 -> 3 (FRAMES), sharded 3 -> 2, sharded_stream
2 -> 1 (SHARDED_PATHS), table256 2 -> 1. No shape was cut. The four phases
after bench_bf16 add about a minute and cut nothing; the blitz runs at
64^3 here (its full 128^3 form is `python3 -m
flipviscosity3d_torch.scripts.hw_blitz`).

6. Prints the card line, one JSON line of kernel records, and as its last
   line {"ok": true, "device": {...}} when every check held; otherwise
   prints what failed and exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 128
FRAMES = 3
TERMS2_FRAMES = 2
LARGE_RES = 256
SCENE_DIR = os.path.join(ROOT, "build", "smoke_scenes")
TABLE256 = dict(particle_engine=None, bucket_capacity=12)
# the slab pipeline's paths at RES: (name, particle engine, timed frames)
# the V-cycle modules' chains in the scripts phase (50 in the JAX scripts)
SCRIPT_K = 20
SHARDED_PATHS = (("sharded", "pallas", 2), ("sharded_stream", "stream", 1))
# the placed path's and the dry run's rank-threads; the blitz's grid
PLACED_RANKS = 4
BLITZ_RES = 64
RECORD_KEYS = ("name", "route", "source", "replaces", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from flipviscosity3d_torch import _build, smoke
        from flipviscosity3d_torch.scripts import card as read_card
        from flipviscosity3d_torch.scripts.bench import DT, bench_scene
    except ImportError as e:
        print(f"chip_smoke: the flipviscosity3d_torch package is missing "
              f"beside this script ({e})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = read_card()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()} "
          f"({torch.cuda.get_device_name(0)})", flush=True)

    t0 = time.perf_counter()
    info = _build.build()
    print(f"build: {info['seconds']:.1f} s nvcc, {info['path']}")
    print(info["log"].strip(), flush=True)

    failures = []
    sim = bench_scene("cuda", RES)
    print(f"scene: {RES}^3, {sim.state.pos.shape[0]} particles, set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def print_records(records, at):
        """One line per kernel record and one per V-cycle level, each with
        the card."""
        for r in records:
            levels = r.pop("levels", [])
            print(json.dumps({"at": at, **r, "card": card}), flush=True)
            for line in levels:
                print(json.dumps({"at": at, "vcycle_level": line,
                                  "card": card}), flush=True)

    records = smoke.check_kernels(sim.state, sim.cfg, log=lambda _: None)
    print_records(records, f"{RES}^3")
    failures += [f"kernel {r['name']} disagrees with its plain version"
                 for r in records if not r["ok"]]

    def route(sim, at):
        """One more frame of `sim`, then the unfused route against K2 on
        its state, the grids of the frame before as the second grid."""
        prev = (sim.state.u, sim.state.v, sim.state.w)
        sim.advance(DT)
        rec = smoke.check_unfused_route(sim.state, prev, sim.cfg,
                                        log=lambda _: None)
        print(json.dumps({"at": at, **rec, "card": card}), flush=True)
        if not rec["ok"]:
            failures.append(f"the unfused route disagrees with K2 at {at}")

    sim.advance(DT)
    route(sim, f"{RES}^3")
    del sim
    torch.cuda.empty_cache()

    launches = {r["name"]: 0 for r in records}
    bench_rate = {}

    def report(name, result):
        """Count a path's failures and launches and print its summary."""
        failures.extend(f"path {name}: {f}" for f in result["failures"])
        for k in launches:
            launches[k] += result["launches"][k]
        frames = result["frames"]
        print(json.dumps({
            "path": name,
            "particles": result["particles"],
            "timed_frames": result["timed_frames"],
            "substeps": result["substeps"],
            "frame_substeps": [f["substeps"] for f in frames],
            "stale_substeps": result["stale_substeps"],
            "bucket_overflow": result["bucket_overflow"],
            "iterations": [[f["pressure_iterations"],
                            f["viscosity_iterations"]] for f in frames],
            "residuals": [[f["pressure_residual"], f["pressure_tolerance"],
                           f["viscosity_residual"],
                           f["viscosity_tolerance"]] for f in frames],
            "liquid_cells": [f["liquid_cells"] for f in frames],
            "plan_demand": [f["plan_demand"] for f in frames],
            "uncovered": [[f["uncovered_pass_a"], f["uncovered_pass_b"],
                           f["uncovered_pushback"]] for f in frames],
            "substeps_per_s": result["substeps_per_s"],
            "peak_bytes": result["peak_bytes"],
            "setup_s": result["setup_s"],
            "launches": result["launches"],
            "launches_per_substep": result["launches_per_substep"],
            "path_kernels": result["path_kernels"],
            "card": card,
        }), flush=True)
        torch.cuda.empty_cache()

    for name, dt, lift, overrides in smoke.MAIN_PATHS:
        result = smoke.run_main_path("cuda", RES, FRAMES, dt=dt, lift=lift,
                                     **overrides)
        pos = result.pop("sim").state.pos
        if name == "bench":
            bench_pos = pos   # the f32 run that "bench_bf16" is held against
            bench_frames = result["frames"]
            # the single-device rate the sharded paths are printed beside
            bench_rate[RES] = result["substeps_per_s"]
        del pos
        report(name, result)
    result = smoke.run_main_path("cuda", RES, TERMS2_FRAMES,
                                 pallas_split_terms=2)
    del result["sim"]
    side = {k: [[f[k] for f in frames[:TERMS2_FRAMES + 1]]
                for frames in (result["frames"], bench_frames)]
            for k in ("substeps", "pressure_iterations",
                      "viscosity_iterations", "max_velocity")}
    print(json.dumps({"path": "bench_terms2", "vs": "bench (terms 3)",
                      **side}), flush=True)
    if side["max_velocity"][0] == side["max_velocity"][1]:
        result["failures"].append(
            "max|u| equals the terms-3 run's in every frame")
    report("bench_terms2", result)
    for name, dt, lift, overrides in smoke.ENGINE_PATHS:
        result = smoke.run_main_path("cuda", RES, FRAMES, dt=dt, lift=lift,
                                     **overrides)
        del result["sim"]
        report(name, result)

    def report_sharded(name, result, res):
        """A slab-pipeline path's summary line (its frame lines came
        before); count its failures and launches."""
        failures.extend(f"path {name}: {f}" for f in result["failures"])
        for k in launches:
            launches[k] += result["launches"][k]
        frames = result["frames"]
        print(json.dumps({
            "path": name,
            "particles": result["particles"],
            "slabs": result["slabs"],
            "engine": result["engine"],
            "timed_frames": result["timed_frames"],
            "substeps": result["substeps"],
            "frame_substeps": [f["substeps"] for f in frames],
            "iterations": [[f["pressure_iterations"],
                            f["viscosity_iterations"]] for f in frames],
            "residuals": [[f["pressure_residual"], f["pressure_tolerance"],
                           f["viscosity_residual"],
                           f["viscosity_tolerance"]] for f in frames],
            "bucket_overflow": [f["bucket_overflow"] for f in frames],
            "liquid_cells": [f["liquid_cells"] for f in frames],
            "migrated": [f["migrated"] for f in frames],
            "migration_lost": [f["migration_lost"] for f in frames],
            "uncovered_per_slab": [f["uncovered_per_slab"] for f in frames],
            "vs_single_device": result["vs_single_device"],
            "substeps_per_s": result["substeps_per_s"],
            "single_device_substeps_per_s": bench_rate[res],
            "peak_bytes": result["peak_bytes"],
            "launches": result["launches"],
            "launches_per_substep": [f["launches_per_substep"]
                                     for f in frames],
            "collectives_per_substep": frames[-1][
                "collectives_per_substep"],
            "path_kernels": result["path_kernels"],
            "card": card,
        }), flush=True)
        torch.cuda.empty_cache()

    for name, engine, frames in SHARDED_PATHS:
        result = smoke.run_sharded_path("cuda", RES, frames, engine=engine)
        del result["state"]
        report_sharded(name, result, RES)
    result = smoke.run_sharded_dist(
        "cuda", RES, os.path.join(ROOT, "build", "sharded_dist.store"))
    print(json.dumps({"path": "sharded_dist", **result, "card": card}),
          flush=True)
    failures.extend(f"path sharded_dist: {f}" for f in result["failures"])
    torch.cuda.empty_cache()

    def report_checks(name, result, lines):
        """Print a check path's result `lines` and summary; count its
        failures and launches."""
        for line in lines:
            print(json.dumps({**line, "card": card}), flush=True)
        failures.extend(f"path {name}: {f}" for f in result["failures"])
        for k in launches:
            launches[k] += result["launches"][k]
        print(json.dumps({"path": name, "wall_s": result["wall_s"],
                          "launches": result["launches"],
                          "path_kernels": result["path_kernels"],
                          "card": card}), flush=True)
        torch.cuda.empty_cache()

    result = smoke.run_hw_check("cuda", RES, large_res=LARGE_RES,
                                log=lambda _: None)
    report_checks("hw_check", result, result["modules"])
    result = smoke.run_proto("cuda", RES, log=lambda _: None)
    report_checks("proto", result, [result["result"]])
    runs = tuple((m, {**a, "k": SCRIPT_K} if "k" in a else a, kernels)
                 for m, a, kernels in smoke.SCRIPT_RUNS)
    result = smoke.run_scripts("cuda", runs, log=lambda _: None)
    report_checks("scripts", result, result["modules"])

    result = smoke.run_gather_dtype_path("cuda", RES, FRAMES, bench_pos)
    del bench_pos
    print(json.dumps({
        "path": "bench_bf16",
        "max_abs_diff_from_f32": result.get("max_abs_diff_from_f32")}))
    report("bench_bf16", result)

    result = smoke.run_stream_repeat("cuda", RES, log=lambda _: None)
    print(json.dumps({"path": "stream_repeat", **result, "card": card}),
          flush=True)
    failures.extend(f"path stream_repeat: {f}" for f in result["failures"])
    torch.cuda.empty_cache()

    result = smoke.run_placed_path("cuda", RES, n_ranks=PLACED_RANKS,
                                   log=lambda line: print(line, flush=True))
    for k in launches:
        launches[k] += result["launches"][k]
    print(json.dumps({"path": "placed", **result, "card": card}), flush=True)
    failures.extend(f"path placed: {f}" for f in result["failures"])
    torch.cuda.empty_cache()

    result = smoke.run_dryrun("cuda", PLACED_RANKS,
                              log=lambda line: print(line, flush=True))
    print(json.dumps({"path": "dryrun", **result, "card": card}), flush=True)
    failures.extend(f"path dryrun: {f}" for f in result["failures"])
    torch.cuda.empty_cache()

    from flipviscosity3d_torch.scripts import hw_blitz
    t_blitz = time.perf_counter()
    blitz_launches = dict.fromkeys(launches, 0)

    def blitz_line(line):
        step = json.loads(line)
        for k, v in step.get("launches", {}).items():
            blitz_launches[k] += v
        step.get("result", {}).pop("rows", None)
        print(json.dumps({"hw_blitz": step, "card": card}), flush=True)

    result = hw_blitz.run("cuda", res=BLITZ_RES, frames=1, log=blitz_line)
    for k in launches:
        launches[k] += blitz_launches[k]
    print(json.dumps({"path": "hw_blitz", **result,
                      "wall_s": time.perf_counter() - t_blitz,
                      "launches": blitz_launches, "card": card}), flush=True)
    failures.extend(f"path hw_blitz: step {s} failed" for s in result["failed"])
    torch.cuda.empty_cache()

    result = smoke.run_cli64("cuda", SCENE_DIR)
    print(json.dumps({
        "path": "cli64",
        "obj_max_abs_err": result["obj_max_abs_err"],
        "resumed_final_max_abs_diff": result["resumed_final_max_abs_diff"]}))
    report("cli64", result)

    result = smoke.run_scene_path("cuda", SCENE_DIR, "bench256", LARGE_RES,
                                  3)
    run = result.pop("run")
    bench_rate[LARGE_RES] = result["substeps_per_s"]
    report("bench256", result)
    route(run.sim, f"{LARGE_RES}^3")
    state, cfg = run.sim.state, run.sim.cfg
    del run, result
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    large = smoke.check_kernels(state, cfg, ref_slabs=16, log=lambda _: None)
    print_records(large, f"{LARGE_RES}^3")
    print(json.dumps({"kernel_checks_at": f"{LARGE_RES}^3",
                      "peak_bytes": torch.cuda.max_memory_allocated()}))
    failures += [f"kernel {r['name']} disagrees with its plain version at "
                 f"{LARGE_RES}^3" for r in large if not r["ok"]]
    del state, large
    torch.cuda.empty_cache()

    _, dt, lift, overrides = smoke.MAIN_PATHS[1]
    result = smoke.run_scene_path("cuda", SCENE_DIR, "stale256", LARGE_RES,
                                  2, dt=dt, lift=lift, **overrides)
    del result["run"]
    report("stale256", result)
    del result
    torch.cuda.empty_cache()

    result = smoke.run_scene_path("cuda", SCENE_DIR, "table256", LARGE_RES,
                                  1, **TABLE256)
    del result["run"]
    print(json.dumps({"path": "table256", "engine": result["engine"],
                      "scene_names_an_engine": False}), flush=True)
    if result["engine"] != "table":
        result["failures"].append(
            f"the run's config says {result['engine']!r}, not the default "
            "\"table\"")
    report("table256", result)
    del result
    torch.cuda.empty_cache()

    result = smoke.run_sharded_path("cuda", LARGE_RES, 1, compare=False)
    del result["state"]
    report_sharded("sharded256", result, LARGE_RES)
    del result

    if failures:
        for f in failures:
            print(f"FAILED: {f}")
        return 1
    kernels = [{k: r[k] for k in RECORD_KEYS}
               | {"launches": launches[r["name"]]} for r in records]
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
