"""Times the particle kernels K1 scatter_p2g_table (sums in rows of 108 and,
K-folded, of 112 floats), K2 gather_mac (pass A: two grids at the
particles; pass B: one grid at midpoints, in pass-A order), K5
scatter_p2g_table_stale (both strides at pallas_split_terms 3, 1 and 2, on
two stale orders) and K11 tile_scatter (the round-1 prototype's scatter),
for this checkout's package and, with --root, for another's, so that two
commits compare on one card in one call:

    python3 flipviscosity3d_torch/scripts/particle_kernels.py [--res 128]
        [--root DIR] [--device cuda|cpu]

The bench scene (scripts/bench.py's bench_scene: the pool of bench.py at
res^3, 8 particles per cell) is set up by this checkout's package, with
velocities and two sets of grids drawn from a seeded generator, and sorted
as pass A sorts it; the midpoints are scripts.midpoints'. K5 runs on
scripts.stale_orders of the sorted particles ("falling": one substep of the
stale path's fall, every particle covered; "random steps" of up to 1.5
cells, the plans' capacity leaving a tail uncovered) through plan_pass_a at
the config's budget. K11 runs on the prototype's make_scene(res) (at >=
2^24 cells its first 2^23 particles, as chip_smoke holds it), cap 16. The
kernels of each package run on the same tensors. DIR's package
(flipviscosity3d_torch under DIR, e.g. a parent commit unpacked by git
archive) is imported under another name beside this one and called only
through what both packages have.

Prints one JSON line per (package, kernel, case): the device time back to
back (`ms`) and with L2 flushed before each launch (`ms_cold`), each taken
twice in turns (DIR's, this, this, DIR's), the bound
(scripts.scatter_bound, gather_bound, stale_scatter_bound,
tile_scatter_bound: bytes read and written once over 3.35 TB/s, or the f32
operations over 67 TFLOP/s) and the cold time over it; then one line of
checks, with the time of the card's write stream alone (`write_floor`:
zero_ of as many bytes as K1 writes, cold): this package's K1, K5 (at the
exact products, on both orders) and K11 against their plain versions (sums
within rtol 1e-5, atol 1e-6 of max|sums|; tables and counts exact), its K2
torch.equal to its plain version, and with --root whether this package's
K1, K2, K5 (every case: sums, table and counts) and K11 outputs are
torch.equal to DIR's (K2's equality is reported, not required). Exits 1 if
a check fails. Runs the file as a script (not with -m); on --device cpu the
plain versions run and nothing is timed on the card.
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


def load_other(root: str):
    """flipviscosity3d_torch of the checkout at `root`, imported as OTHER
    (its modules import each other relatively) -> (its pallas_particles,
    its scripts.pallas_particle_proto)."""
    pkg = os.path.join(root, "flipviscosity3d_torch")
    spec = importlib.util.spec_from_file_location(
        OTHER, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(OTHER + ".ops.pallas_particles"),
            importlib.import_module(OTHER + ".scripts.pallas_particle_proto"))


def run(res: int, device: str, root: str | None = None, seed: int = 0,
        log=print) -> list:
    """One JSON-ready dict per (package, kernel, case) and a last one of
    checks (see the module docstring)."""
    sys.path.insert(0, ROOT)
    import torch

    from flipviscosity3d_torch import scripts as sc
    from flipviscosity3d_torch.ops import pallas_particles as pp
    from flipviscosity3d_torch.scripts import card, time_ms
    from flipviscosity3d_torch.scripts import pallas_particle_proto as proto
    from flipviscosity3d_torch.scripts.bench import bench_scene

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    packages = {"this": (pp, proto)}
    if root is not None:
        packages["other"] = load_other(os.path.abspath(root))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sim = bench_scene(dev, res)
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
    mx, my, mz, key_m, _ = sc.midpoints(stream.pos, cfg, gen)
    args_b = (mx, my, mz, key_m, gu[:1], gv[:1], gw[:1], dx, shape)
    stale = {}
    for label, moved in sc.stale_orders(stream.pos, cfg, gen).items():
        key5 = pp.key_of_position(moved, dx, shape)
        plan = pp.plan_pass_a(key5, shape, cfg.pallas_passa_budget,
                              cfg.pallas_passa_factor)
        stale[label] = (moved, stream.vel, key5, plan, shape, dx, cap)
    p_pos, p_vel, p_dx, p_shape = proto.make_scene(res)
    if pp.large_grid(p_shape):
        p_pos, p_vel = p_pos[:sc.PROBE_RUN], p_vel[:sc.PROBE_RUN]
    n11 = p_pos.shape[0]
    payload, starts, _ = proto.sort_particles(
        torch.from_numpy(p_pos).to(dev), torch.from_numpy(p_vel).to(dev),
        p_dx, p_shape)
    del p_pos, p_vel
    args11 = (starts, payload, proto.tile_counts(p_shape), p_dx, 16)

    # (kernel, case tags) -> (call of a package's (pp, proto), bound)
    cases = {
        ("scatter_p2g_table", ()): (
            lambda pk: pk[0].scatter_p2g_table(*scatter_args,
                                               fold_sums=False),
            sc.scatter_bound(scatter_args[:4], cfg.n_cells, cap, pp.N_P2G)),
        ("scatter_p2g_table_folded", ()): (
            lambda pk: pk[0].scatter_p2g_table(*scatter_args,
                                               fold_sums=True),
            sc.scatter_bound(scatter_args[:4], cfg.n_cells, cap, pp.SUML)),
        ("gather_mac", ()): (lambda pk: pk[0].gather_mac(*args_a),
                             sc.gather_bound(args_a)),
        ("gather_mac_one_grid", ()): (lambda pk: pk[0].gather_mac(*args_b),
                                      sc.gather_bound(args_b)),
    }
    for label, a in stale.items():
        for fold in (False, True):
            stride = pp.SUML if fold else pp.N_P2G
            name = ("scatter_p2g_table_stale_folded" if fold
                    else "scatter_p2g_table_stale")
            for terms in sc.SPLIT_TERMS:
                cases[(name, (("order", label), ("terms", terms)))] = (
                    lambda pk, a=a, f=fold, t=terms:
                        pk[0].scatter_p2g_table_stale(*a, fold_sums=f,
                                                      terms=t),
                    sc.stale_scatter_bound(a, cfg.n_cells, cap, stride))
    cases[("tile_scatter", (("particles", n11),))] = (
        lambda pk: pk[1].tile_scatter(*args11),
        sc.tile_scatter_bound(payload, starts, 16, n11))

    flush_buf = torch.empty(sc.FLUSH_BYTES // 4 if on_card else 1, device=dev)
    times = {(label, case): {"ms": [], "ms_cold": []}
             for label in packages for case in cases}
    order = ["other", "this", "this", "other"] if root else ["this", "this"]
    for label in order:
        for case, (call, _) in cases.items():
            def fn(pk=packages[label], call=call):
                return call(pk)
            t = times[(label, case)]
            if on_card:
                t["ms"].append(sc.device_ms(fn))
                t["ms_cold"].append(sc.device_ms(fn, flush_buf.zero_))
            else:
                t["ms"].append(time_ms(fn, "cpu", batch_ms=5.0, repeats=1))
    # the card's write stream alone: zero_ of as many bytes as K1 writes
    # (sums and table), cold
    write_floor = None
    if on_card:
        out_bytes = (4 * pp.N_P2G + 16 * cap) * cfg.n_cells
        buf = torch.empty(out_bytes // 4, device=dev)
        write_floor = {"bytes": out_bytes,
                       "ms_cold": sc.device_ms(buf.zero_, flush_buf.zero_)}
        del buf
    del flush_buf
    where = card() if on_card else "cpu"
    lines = []
    for (label, (name, tags)), t in times.items():
        b = cases[(name, tags)][1]
        line = {"package": root if label == "other" else ROOT,
                "kernel": name, **dict(tags), "res": res, "particles": n,
                **t, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "cold_over_bound": (min(t["ms_cold"]) / b["bound_ms"]
                                    if t["ms_cold"] else None),
                "card": where}
        log(json.dumps(line))
        lines.append(line)

    # the plain scatters' (N, 108) values in 16 runs of particles at
    # >= 2^24 cells, to fit the card
    slabs = 16 if pp.large_grid(shape) else 1
    got, want = pp.scatter_p2g_table(*scatter_args), \
        pp.scatter_p2g_table_ref(*scatter_args, slabs=slabs)
    checks = [
        sc.compare("K1 sums vs its plain version", got[0], want[0], 1e-5,
                   1e-6 * sc.max_abs(want[0])),
        {"check": "K1 table exact", "ok": bool(torch.equal(got[1], want[1]))},
    ]
    del got, want
    plain_a = pp.gather_mac_ref(*args_a)
    checks.append(sc.equal("K2 two grids vs its plain version",
                           pp.gather_mac(*args_a), plain_a))
    del plain_a
    checks.append(sc.equal("K2 one grid at midpoints vs its plain "
                           "version", pp.gather_mac(*args_b),
                           pp.gather_mac_ref(*args_b)))
    for label, a in stale.items():
        got = pp.scatter_p2g_table_stale(*a)
        want = pp.scatter_p2g_table_stale_ref(*a[:3], a[3].covered, *a[4:],
                                              slabs=slabs)
        checks += [
            sc.compare(f"K5 ({label}) sums vs its plain version", got[0],
                       want[0], 1e-5, 1e-6 * sc.max_abs(want[0])),
            {"check": f"K5 ({label}) table and counts exact",
             "ok": all(bool(torch.equal(x, y))
                       for x, y in zip(got[1:], want[1:]))}]
        del got, want
    got = proto.tile_scatter(*args11)
    want = proto.tile_scatter_ref(*args11)
    checks += [
        {"check": "K11 slot table exact", "ok": bool(torch.equal(
            got[..., proto.N_SUM:], want[..., proto.N_SUM:]))},
        sc.compare("K11 sums vs its plain version", got[..., :proto.N_SUM],
                   want[..., :proto.N_SUM], 1e-5,
                   1e-6 * sc.max_abs(want[..., :proto.N_SUM]))]
    del got, want
    if root:
        other, other_proto = packages["other"]
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
                "max_abs_diff": sc.max_abs(pp.gather_mac(*args) - theirs),
                "ok": True})
        for (name, tags), (call, _) in cases.items():
            if not name.startswith("scatter_p2g_table_stale"):
                continue
            mine = call(packages["this"])
            theirs = call(packages["other"])
            checks.append({
                "check": f"K5 {name} {dict(tags)} sums, table and counts "
                         f"torch.equal to {root}'s",
                "ok": all(bool(torch.equal(a, b))
                          for a, b in zip(mine, theirs))})
            del mine, theirs
        checks.append({
            "check": f"K11 torch.equal to {root}'s",
            "ok": bool(torch.equal(proto.tile_scatter(*args11),
                                   other_proto.tile_scatter(*args11)))})
    line = {"checks": checks, "ok": all(c["ok"] for c in checks),
            "write_floor": write_floor, "card": where}
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
