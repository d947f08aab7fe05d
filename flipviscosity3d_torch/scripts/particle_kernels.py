"""Times the particle kernels K1 scatter_p2g_table (sums in rows of 108 and,
K-folded, of 112 floats) and K2 gather_mac (pass A: two grids at the
particles; pass B: one grid at midpoints, in pass-A order) on the bench
scene, for this checkout's package and, with --root, for another's, so
that two commits compare on one card in one call:

    python3 flipviscosity3d_torch/scripts/particle_kernels.py [--res 128]
        [--root DIR] [--device cuda|cpu]

The bench scene (smoke.bench_scene: the pool of bench.py at res^3, 8
particles per cell) is set up by this checkout's package, with velocities
and two sets of grids drawn from a seeded generator, and sorted as pass A
sorts it; the midpoints are smoke.midpoints'. The kernels of each package
run on the same tensors. DIR's package (flipviscosity3d_torch under DIR,
e.g. a parent commit unpacked by git archive) is imported under another
name beside this one and called only through what both packages have, at
the exact products (pallas_split_terms 3).

Prints one JSON line per (package, kernel): the device time back to back
(`ms`) and with L2 flushed before each launch (`ms_cold`), each taken twice
in turns (DIR's, this, this, DIR's), the bound (smoke.scatter_bound /
gather_bound: bytes read and written once over 3.35 TB/s, or the f32
operations over 67 TFLOP/s) and the cold time over it; then one line of
checks: this package's K1 against its plain version (rtol 1e-5, atol 1e-6
of max|sums|, tables exact), its K2 torch.equal to its plain version, and
with --root whether this package's K1 and K2 outputs are torch.equal to
DIR's. Exits 1 if a check fails. Runs the file as a script (not with -m);
on --device cpu the plain versions run and nothing is timed on the card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OTHER = "flipviscosity3d_torch_other"
FLUSH_BYTES = 256 << 20


def load_other(root: str):
    """flipviscosity3d_torch of the checkout at `root`, imported as OTHER
    (its modules import each other relatively) -> its pallas_particles."""
    pkg = os.path.join(root, "flipviscosity3d_torch")
    spec = importlib.util.spec_from_file_location(
        OTHER, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = module
    spec.loader.exec_module(module)
    return importlib.import_module(OTHER + ".ops.pallas_particles")


def run(res: int, device: str, root: str | None = None, seed: int = 0,
        log=print) -> list:
    """One JSON-ready dict per (package, kernel) and a last one of checks
    (see the module docstring)."""
    sys.path.insert(0, ROOT)
    import torch

    from flipviscosity3d_torch import smoke
    from flipviscosity3d_torch.ops import pallas_particles as pp
    from flipviscosity3d_torch.scripts import card, time_ms

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    packages = {"this": pp}
    if root is not None:
        packages["other"] = load_other(os.path.abspath(root))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sim = smoke.bench_scene(dev, res)
    cfg, pos = sim.cfg, sim.state.pos
    del sim
    shape, dx, cap = cfg.grid_shape, cfg.dx, cfg.sdf_cap
    n = pos.shape[0]
    vel = 0.5 * torch.randn((n, 3), generator=gen, device=dev)
    stream = pp.tiled_sort(pos, vel, dx, shape)
    del pos, vel
    scatter_args = (stream.pos, stream.vel, stream.key, stream.rank, shape,
                    dx, cap)
    faces = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    grids = [[torch.randn(fs, generator=gen, device=dev) for fs in faces]
             for _ in range(2)]
    gu, gv, gw = ([grids[0][c], grids[1][c]] for c in range(3))
    px, py, pz = (stream.pos[:, a].contiguous() for a in range(3))
    args_a = (px, py, pz, stream.key, gu, gv, gw, dx, shape)
    mx, my, mz, key_m, _ = smoke.midpoints(stream.pos, cfg, gen)
    args_b = (mx, my, mz, key_m, gu[:1], gv[:1], gw[:1], dx, shape)

    def kernels(pk):
        return {
            "scatter_p2g_table": lambda: pk.scatter_p2g_table(
                *scatter_args, fold_sums=False),
            "scatter_p2g_table_folded": lambda: pk.scatter_p2g_table(
                *scatter_args, fold_sums=True),
            "gather_mac": lambda: pk.gather_mac(*args_a),
            "gather_mac_one_grid": lambda: pk.gather_mac(*args_b),
        }

    bounds = {
        "scatter_p2g_table": smoke.scatter_bound(
            scatter_args[:4], cfg.n_cells, cap, pp.N_P2G),
        "scatter_p2g_table_folded": smoke.scatter_bound(
            scatter_args[:4], cfg.n_cells, cap, pp.SUML),
        "gather_mac": smoke.gather_bound(args_a),
        "gather_mac_one_grid": smoke.gather_bound(args_b),
    }
    flush_buf = torch.empty(FLUSH_BYTES // 4 if on_card else 1, device=dev)
    times = {(label, name): {"ms": [], "ms_cold": []}
             for label in packages for name in bounds}
    order = ["other", "this", "this", "other"] if root else ["this", "this"]
    for label in order:
        for name, fn in kernels(packages[label]).items():
            t = times[(label, name)]
            if on_card:
                t["ms"].append(smoke.device_ms(fn))
                t["ms_cold"].append(smoke.device_ms(fn, flush_buf.zero_))
            else:
                t["ms"].append(time_ms(fn, "cpu", batch_ms=5.0, repeats=1))
    del flush_buf
    where = card() if on_card else "cpu"
    lines = []
    for (label, name), t in times.items():
        b = bounds[name]
        line = {"package": root if label == "other" else ROOT,
                "kernel": name, "res": res, "particles": n, **t,
                "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "cold_over_bound": (min(t["ms_cold"]) / b["bound_ms"]
                                    if t["ms_cold"] else None),
                "card": where}
        log(json.dumps(line))
        lines.append(line)

    # the plain version's (N, 108) values in 16 runs of particles at
    # >= 2^24 cells, to fit the card
    slabs = 16 if pp.large_grid(shape) else 1
    got, want = pp.scatter_p2g_table(*scatter_args), \
        pp.scatter_p2g_table_ref(*scatter_args, slabs=slabs)
    checks = [
        smoke.compare("K1 sums vs its plain version", got[0], want[0], 1e-5,
                      1e-6 * smoke._max_abs(want[0])),
        {"check": "K1 table exact", "ok": bool(torch.equal(got[1], want[1]))},
    ]
    del want
    plain_a = pp.gather_mac_ref(*args_a)
    checks.append(smoke._equal("K2 two grids vs its plain version",
                               pp.gather_mac(*args_a), plain_a))
    checks.append(smoke._equal("K2 one grid at midpoints vs its plain "
                               "version", pp.gather_mac(*args_b),
                               pp.gather_mac_ref(*args_b)))
    if root:
        other = packages["other"]
        for fold in (False, True):
            mine = pp.scatter_p2g_table(*scatter_args, fold_sums=fold)
            theirs = other.scatter_p2g_table(*scatter_args, fold_sums=fold)
            checks.append({
                "check": f"K1 (fold {fold}) torch.equal to {root}'s",
                "ok": all(bool(torch.equal(a, b))
                          for a, b in zip(mine, theirs))})
            del mine, theirs
        for label, args in (("two grids", args_a), ("one grid", args_b)):
            theirs = other.gather_mac(*args)
            checks.append({
                "check": f"K2 ({label}) torch.equal to {root}'s",
                "equal": bool(torch.equal(pp.gather_mac(*args), theirs)),
                "max_abs_diff": smoke._max_abs(pp.gather_mac(*args) - theirs),
                "ok": True})
    line = {"checks": checks, "ok": all(c["ok"] for c in checks),
            "card": where}
    log(json.dumps(line))
    lines.append(line)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--root", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("particle_kernels: no CUDA device; pass --device cpu",
                  file=sys.stderr)
            return 1
    lines = run(args.res, args.device, args.root)
    return 0 if lines[-1]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
