"""The bench scene, the main path run, and the kernel-vs-plain checks.

`run_main_path(device, res, frames)` builds the scene that bench.py runs
(a pool filling the bottom ~27% of the box, viscosity 5, gravity -9.81)
through FluidSimulation, runs one warm frame and `frames` timed frames of
dt = 0.01, and reports diagnostics, throughput, peak memory, the kernels'
launch counts and the failed checks. `check_kernels(state, cfg)` holds
each CUDA kernel against its plain PyTorch version on the same inputs and
times both. chip_smoke.py runs both at 128^3 on the card; the CPU tests run
the main path at 16^3. `profile_frames(res, frames)` traces frames of the
scene on the card with torch.profiler (where the time goes).
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from .config import SimConfig
from .core.sim import FluidSimulation
from .core.step import _clamp_bounds
from .io.trianglemesh import box_mesh
from .ops import pallas_mg as pm
from .ops import pallas_particles as pp
from .solvers import multigrid as mg

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
)
DT = 0.01


def reset_launch_counts() -> None:
    for fn, _, _ in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn, _, _ in KERNELS}


def bench_scene(device, res: int) -> FluidSimulation:
    """bench.py's scene (bench.py:35-100) at res^3."""
    sim = FluidSimulation(device)
    sim.initialize(res, res, res, 1.0 / res, bucket_capacity=16)
    lo = 2.5 / res
    sim.add_liquid(box_mesh((lo, lo, lo), (1.0 - lo, 0.285, 1.0 - lo)))
    sim.set_viscosity(5.0)
    sim.set_gravity(0.0, -9.81, 0.0)
    return sim


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_main_path(device, res: int, frames: int, log=print) -> dict:
    """Drive FluidSimulation on the bench scene: one warm frame, then
    `frames` timed frames. Returns a dict of results; `failures` lists the
    checks that did not hold."""
    dev = torch.device(device)
    sim = bench_scene(dev, res)
    n = int(sim.state.pos.shape[0])
    log(json.dumps({"scene": f"{res}^3", "particles": n, "device": str(dev)}))
    reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    diags = []
    for frame in range(frames + 1):
        if frame == 1:
            _sync(dev)
            t0 = time.perf_counter()
        d = sim.advance(DT)
        diags.append(d)
        log(json.dumps({"frame": frame, "warm": frame == 0, **d.as_dict()}))
    _sync(dev)
    wall = time.perf_counter() - t0
    substeps = sum(d.substeps for d in diags[1:])
    result = {
        "particles": n,
        "frames": [d.as_dict() for d in diags],
        "timed_frames": frames,
        "substeps": substeps,
        "wall_s": wall,
        "substeps_per_s": substeps / wall,
        "peak_bytes": (torch.cuda.max_memory_allocated()
                       if dev.type == "cuda" else None),
        "launches": launch_counts(),
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
        if not d.pressure_residual <= d.pressure_tolerance:
            failures.append(
                f"frame {i}: pressure residual {d.pressure_residual} above "
                f"its tolerance {d.pressure_tolerance}")
    if not any(d.viscosity_iterations > 0 for d in diags):
        failures.append("no frame ran the viscosity solve")
    if dev.type == "cuda":
        failures += [f"kernel {k} was never launched"
                     for k, c in result["launches"].items() if c == 0]
    return failures


# ---------------------------------------------------------------------------
# kernel vs plain version, on the card
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of fn() over `reps` runs after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, rtol, atol) -> dict:
    """max abs / rel error of got vs want and whether
    |got - want| <= atol + rtol * |want| everywhere."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = err / want.abs().clamp(min=1e-30)
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    return {"check": name, "max_abs_err": float(err.max()),
            "max_rel_err": float(rel.max()), "rtol": rtol, "atol": atol,
            "ok": ok}


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


def check_kernels(state, cfg: SimConfig, seed: int = 0, log=print) -> list:
    """Each kernel against its plain version on the card at the shapes the
    main path gives it: K1 on the scene's sorted particles, K2 with two
    grids at the particles and one grid at midpoints (some outside the
    domain), K3/K4 on a pressure-sized (1,I,J,K) and a viscosity-sized
    (3,I+1,J+1,K+1) level with the bf16 operator, and a whole V-cycle on
    each. Returns one record per kernel with its checks, kernel and plain
    times."""
    dev = state.pos.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape, dx, cap = cfg.grid_shape, cfg.dx, cfg.sdf_cap
    n = state.pos.shape[0]
    records = {}

    # K1: P2G scatter + slot table
    vel = 0.5 * torch.randn((n, 3), generator=gen, device=dev)
    stream = pp.tiled_sort(state.pos, vel, dx, shape)
    args = (stream.pos, stream.vel, stream.key, stream.rank, shape, dx, cap)
    ks, kt = pp.scatter_p2g_table(*args)
    rs, rt = pp.scatter_p2g_table_ref(*args)
    checks = [compare("sums", ks, rs, 1e-5, 1e-6 * float(rs.abs().max())),
              {"check": "table exact", "ok": bool(torch.equal(kt, rt))}]
    occupied_k = int(kt[..., 3].sum())
    overflow = int((stream.rank >= cap).sum())
    checks.append({"check": "overflow", "kernel": n - occupied_k,
                   "plain": overflow, "ok": n - occupied_k == overflow})
    records["scatter_p2g_table"] = (
        checks, lambda: pp.scatter_p2g_table(*args),
        lambda: pp.scatter_p2g_table_ref(*args))

    # K2: G2P gather, pass A (2 grids) and pass B (1 grid at midpoints)
    faces = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    grids = [[torch.randn(fs, generator=gen, device=dev) for fs in faces]
             for _ in range(2)]
    gu, gv, gw = ([grids[0][c], grids[1][c]] for c in range(3))
    px, py, pz = (stream.pos[:, a].contiguous() for a in range(3))
    args_a = (px, py, pz, stream.key, gu, gv, gw, dx, shape)
    mid = stream.pos + 3.0 * dx * torch.randn((n, 3), generator=gen,
                                              device=dev)
    mx, my, mz = (mid[:, a].contiguous() for a in range(3))
    key_m = pp.key_of_position(mid, dx, shape)
    args_b = (mx, my, mz, key_m, gu[:1], gv[:1], gw[:1], dx, shape)
    outside = int(((mid < 0) | (mid >= shape[0] * dx)).any(dim=1).sum())
    checks = [
        compare("n_grids=2 at particles", pp.gather_mac(*args_a),
                pp.gather_mac_ref(*args_a), 1e-5, 1e-6),
        compare(f"n_grids=1 at midpoints ({outside} outside the domain)",
                pp.gather_mac(*args_b), pp.gather_mac_ref(*args_b),
                1e-5, 1e-6),
    ]
    records["gather_mac"] = (checks, lambda: pp.gather_mac(*args_a),
                             lambda: pp.gather_mac_ref(*args_a))

    # K3 / K4 on both solves' fine level shapes, bf16 operator
    down_checks, up_checks = [], []
    times = {}
    for label, lshape in (
            ("pressure", (1,) + tuple(shape)),
            ("viscosity", (3,) + tuple(s + 1 for s in shape))):
        diag, links, b = _random_level(lshape, gen, dev)
        d16 = diag.to(torch.bfloat16)
        l16 = tuple(lk.to(torch.bfloat16) for lk in links)
        xk, rck = pm.mg_down(d16, l16, b, cfg.mg_omega)
        xr, rcr = pm.mg_down_ref(d16, l16, b, cfg.mg_omega)
        down_checks += [compare(f"{label} {lshape} x", xk, xr, 2e-5, 2e-5),
                        compare(f"{label} rc", rck, rcr, 2e-5, 2e-5)]
        xc = torch.randn(rcr.shape, generator=gen, device=dev)
        up_args = (d16, l16, b, xr, xc, cfg.mg_omega, cfg.mg_coarse_scale)
        up_checks.append(compare(f"{label} {lshape} x_out",
                                 pm.mg_up(*up_args), pm.mg_up_ref(*up_args),
                                 2e-5, 2e-5))
        hier = mg.build_hierarchy(diag, links, cfg)
        vk = mg.v_cycle(hier, b, 1, 1, cfg.mg_omega, cfg.mg_coarse_scale)
        vr = _v_cycle_plain(hier, b, cfg.mg_omega, cfg.mg_coarse_scale)
        cyc = compare(f"{label} whole V-cycle ({len(hier.levels)} levels)",
                      vk, vr, 2e-5, 2e-5)
        down_checks.append(cyc)
        up_checks.append(cyc)
        if label == "viscosity":
            times["mg_down"] = (
                lambda: pm.mg_down(d16, l16, b, cfg.mg_omega),
                lambda: pm.mg_down_ref(d16, l16, b, cfg.mg_omega))
            times["mg_up"] = (lambda: pm.mg_up(*up_args),
                              lambda: pm.mg_up_ref(*up_args))
    records["mg_down"] = (down_checks, *times["mg_down"])
    records["mg_up"] = (up_checks, *times["mg_up"])

    out = []
    for fn, source, replaces in KERNELS:
        checks, kern, plain = records[fn.__name__]
        rec = {
            "name": fn.__name__, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": max(c.get("max_abs_err", 0.0) for c in checks),
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "ok": all(c["ok"] for c in checks), "checks": checks,
        }
        log(json.dumps(rec))
        out.append(rec)
    return out


def profile_frames(res: int, frames: int, top: int = 25) -> dict:
    """Trace `frames` frames of the bench scene on the card (after one warm
    frame) with torch.profiler: wall time, summed device kernel time, and
    the `top` operators by device self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sim = bench_scene("cuda", res)
    sim.advance(DT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        substeps = sum(sim.advance(DT).substeps for _ in range(frames))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies), so no time counts twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: -e.self_device_time_total)
    return {
        "frames": frames, "substeps": substeps, "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "top": [{"name": e.key[:90], "calls": e.count,
                 "device_ms": e.self_device_time_total / 1e3}
                for e in events[:top]],
    }
