"""Per-stage table of the "pallas" particle engine at bench scale.

    python -m flipviscosity3d_torch.scripts.pallas_engine_probe
        [--device cpu] [--n 4100000] [--res 128]

Counterpart of the JAX package's scripts/pallas_engine_probe.py (its N and
RES arguments are --n and --res): the engine's functions on the bench
distribution (n uniform positions in the bottom quarter of the box, N(0,
0.1) velocities, made on the device from a torch.Generator), over its
passes:

- pass A: the tile-key sort, K1 scatter_p2g_table, the slot table's
  fields (the plain sweep's relayout), the liquid SDF (K15 over the
  table, as the step runs it), the face combine, K2 gather_mac of two
  grids;
- pass B: a re-sort by midpoint key, K2 of one grid (gather_mac_one_grid);
- B': the midpoint plan over pass A's order and K2 of one grid, with the
  plan's coverage and visits;
- stale pass A: plan_pass_a over positions moved from the sorted order by
  up to 2.5 cells, K5 scatter_p2g_table_stale, K2 of two grids, with the
  plan's coverage and visits;
- pushback: the row gather of the node SDF against K6 gather_rows8.

The JAX rows that time its TPU layout (the 64-lane relayout, the column
images K2 reads, the payloads of the gathers and the stale scatter) time
what the port's step does in their place, and name it in the row's "port"
field: K2 reads the grids and K5 the positions directly, so those rows
time no more than the step hands them. The grids K2 samples have the face
shapes the step gives it. "visits" is the JAX plan's visit count (its
static capacity), "demand" the visits the chunks ask for.
"""

from __future__ import annotations

import sys

import torch

from ..core.step import _gather_grids
from ..config import SimConfig
from ..ops import pallas_particles as pp
from ..ops import stream_transfers as st
from ..ops.buckets import cell_of_position
from . import main, resolve_device, stage

CAP = 16
# every row of the JAX script, in its order
ROWS = ("tiled_sort+plan (pass A)", "  alt: sort(key,idx)+take",
        "scatter (sums direct 4D)", "table_fields (64-lane relayout)",
        "liquid_sdf_from_fields", "p2g_combine", "build+tile cols (A, 108)",
        "gather_mac (A, 2 grids)", "sort_by_key+plan (pass B)",
        "build+tile cols (B, 54)", "gather_payload (B)",
        "gather_mac (B, 1 grid)", "plan_midpoint_visits (B')",
        "gather_payload (B')", "gather_mac (B', 1 grid)",
        "plan_pass_a (stale, 2 plans)", "stale_payload",
        "scatter (in-kernel rank)", "gather_mac (A, stale plan)",
        "pushback: XLA row gather", "pushback: packed kernel")
# the rows the JAX script adds up to its particle-work total
TOTAL_ROWS = ROWS[0:1] + ROWS[2:10] + ROWS[11:12]
NO_COLUMNS = ("no column build: K2 reads the grids (the step's "
              "_gather_grids under pallas_gather_dtype f32)")
PORT = {
    "tiled_sort+plan (pass A)": "tiled_sort: sort and in-cell ranks; K1 "
                                "walks the sorted stream, no visit plan",
    "table_fields (64-lane relayout)": "table_fields: slot-major (x, y, z)"
                                       " views of the slot table (the plain"
                                       " sweep's; K15 reads the table)",
    "liquid_sdf_from_fields": "K15 liquid_sdf_from_table over the slot "
                              "table, as the step",
    "build+tile cols (A, 108)": NO_COLUMNS,
    "sort_by_key+plan (pass B)": "sort_by_key of the nine pass-B fields, "
                                 "no visit plan",
    "build+tile cols (B, 54)": NO_COLUMNS,
    "gather_payload (B)": "no payload: K2 reads the sorted midpoint columns",
    "gather_payload (B')": "no payload: key_of_position and the midpoint "
                           "columns K2 reads",
    "stale_payload": "no payload: key_of_position; K5 reads positions and "
                     "velocities in stream order",
    "pushback: XLA row gather": "stream_transfers.solid_pushback_at (the "
                                "step's pushback \"gather\")",
    "pushback: packed kernel": "no column pack: the midpoint plan, K6 "
                               "gather_rows8 on the node SDF, "
                               "pushback_from_corners",
}


def _jitter(pos, dx, gen):
    """pos + uniform(-2.5 dx, 2.5 dx) per axis, clipped to [0.001, 0.999]
    (pallas_engine_probe.py:141-145)."""
    step = (torch.rand(pos.shape, generator=gen, device=pos.device) * 5.0
            - 2.5) * dx
    return torch.clamp(pos + step, 0.001, 0.999)


def midpoint_counts(key) -> dict:
    """Coverage and visits of the midpoint plan over keys in stream order:
    what the JAX script prints for B' (pallas_engine_probe.py:150-156)."""
    n = int(key.shape[0])
    plan = pp.plan_midpoint_visits(key)
    covered = int(plan.covered.sum())
    return {"covered": covered, "coverage": covered / n,
            "visits": pp.midpoint_plan_size(n), "demand": int(plan.visits)}


def pass_a_counts(key, grid_shape) -> dict:
    """The same for the stale pass A's plans: the JAX scatter plan's visits
    hold one more per tile (pallas_engine_probe.py:180-182)."""
    n = int(key.shape[0])
    plan = pp.plan_pass_a(key, grid_shape)
    covered = int(plan.covered.sum())
    n_tiles = grid_shape[0] * grid_shape[1] * grid_shape[2] // pp.W
    return {"covered": covered, "coverage": covered / n,
            "visits": pp.midpoint_plan_size(n) + n_tiles,
            "demand": int(plan.visits)}


def run(device="cuda", n: int = 4_100_000, res: int = 128,
        log=print) -> dict:
    dev = resolve_device(device)
    shape, dx = (res,) * 3, 1.0 / res
    cfg = SimConfig(isize=res, jsize=res, ksize=res, dx=dx)
    fsh = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lo = torch.tensor([0.02, 0.02, 0.02], device=dev)
    hi = torch.tensor([0.98, 0.27, 0.98], device=dev)
    pos = torch.rand((n, 3), generator=gen, device=dev) * (hi - lo) + lo
    vel = torch.randn((n, 3), generator=gen, device=dev) * 0.1
    log(f"N={n} res={res} device={dev}")
    rows = []

    def row(name, fn):
        r, out = stage(name, fn, dev, log)
        if name in PORT:
            r["port"] = PORT[name]
        rows.append(r)
        return out

    stream = row(ROWS[0], lambda: pp.tiled_sort(pos, vel, dx, shape))

    def sort_idx():
        key = pp.key_of_position(pos, dx, shape)
        key_s, idx = torch.sort(key, stable=True)
        return key_s, torch.cat([pos, vel], dim=1)[idx]

    row(ROWS[1], sort_idx)
    sums, table = row(ROWS[2], lambda: pp.scatter_p2g_table(
        stream.pos, stream.vel, stream.key, stream.rank, shape, dx, CAP))
    row(ROWS[3], lambda: pp.table_fields(table, CAP))
    solid_phi = torch.ones(shape, device=dev)
    row(ROWS[4], lambda: pp.liquid_sdf_from_table(
        table, CAP, shape, dx, 0.5 * dx, solid_phi))
    row(ROWS[5], lambda: pp.p2g_combine(sums, shape, fsh))
    grids = [torch.randn(fsh[i // 2], generator=gen, device=dev)
             for i in range(6)]
    row(ROWS[6], lambda: _gather_grids(cfg, *grids))
    spx, spy, spz = (stream.pos[:, a].contiguous() for a in range(3))
    row(ROWS[7], lambda: pp.gather_mac(
        spx, spy, spz, stream.key, grids[0:2], grids[2:4], grids[4:6], dx,
        shape))

    # pass B: a re-sort by the midpoint key
    mid = _jitter(pos, dx, gen)
    key_b, sorted_b = row(ROWS[8], lambda: pp.sort_by_key(
        pp.key_of_position(mid, dx, shape),
        (mid[:, 0], mid[:, 1], mid[:, 2], spx, spy, spz,
         spx * 0.1, spy * 0.1, spz * 0.1)))
    row(ROWS[9], lambda: _gather_grids(cfg, *grids[0::2]))
    bm = row(ROWS[10], lambda: tuple(f.contiguous() for f in sorted_b[:3]))
    g1 = (grids[0], grids[2], grids[4])
    row(ROWS[11], lambda: pp.gather_mac_one_grid(*bm, key_b, *g1, dx, shape))
    total = sum(r["wall_ms"] for r in rows if r["stage"] in TOTAL_ROWS)
    total_dev = (None if rows[0]["device_ms"] is None else sum(
        r["device_ms"] for r in rows if r["stage"] in TOTAL_ROWS))

    # B': the midpoint plan over pass A's order
    mid_a = _jitter(stream.pos, dx, gen)
    key_m = pp.key_of_position(mid_a, dx, shape)
    row(ROWS[12], lambda: pp.plan_midpoint_visits(key_m))
    b_prime = midpoint_counts(key_m)
    log(f"    coverage {b_prime['coverage']:.6f}  visits "
        f"{b_prime['visits']}  demand {b_prime['demand']}")

    def midpoint_columns():
        key = pp.key_of_position(mid_a, dx, shape)
        return key, tuple(mid_a[:, a].contiguous() for a in range(3))

    key_m, mcols = row(ROWS[13], midpoint_columns)
    row(ROWS[14], lambda: pp.gather_mac_one_grid(*mcols, key_m, *g1, dx,
                                                 shape))
    plan_b = rows[-3]["wall_ms"] + rows[-1]["wall_ms"]
    log(f"{'pass-B plan vs sort':28s} {plan_b:9.2f} ms vs the sort path's "
        "rows above")

    # stale pass A: plans over positions moved from the sorted order
    pos_st = _jitter(stream.pos, dx, gen)
    key_st = pp.key_of_position(pos_st, dx, shape)
    plan = row(ROWS[15], lambda: pp.plan_pass_a(key_st, shape))
    stale = pass_a_counts(key_st, shape)
    log(f"    pass-A coverage {stale['coverage']:.6f}  visits "
        f"{stale['visits']}  demand {stale['demand']}")
    row(ROWS[16], lambda: pp.key_of_position(pos_st, dx, shape))
    row(ROWS[17], lambda: pp.scatter_p2g_table_stale(
        pos_st, vel, key_st, plan, shape, dx, CAP))
    sx, sy, sz = (pos_st[:, a].contiguous() for a in range(3))
    row(ROWS[18], lambda: pp.gather_mac(
        sx, sy, sz, key_st, grids[0:2], grids[2:4], grids[4:6], dx, shape))
    stale_total = sum(r["wall_ms"] for r in rows[-4:])
    log(f"{'stale pass-A total':28s} {stale_total:9.2f} ms (sort path: "
        "sort+scatter+gather above)")

    # pushback: the row gather against K6
    phi_node = torch.randn((res + 1,) * 3, generator=gen, device=dev)
    cp = stream.pos
    row(ROWS[19], lambda: st.solid_pushback_at(
        spx, spy, spz, cell_of_position(cp, dx, shape), phi_node, dx,
        shape))

    def pushback_kernel():
        key_k = pp.key_of_position(cp, dx, shape)
        ok = pp.plan_midpoint_visits(key_k).covered
        corners = pp.gather_rows8(key_k, ok, phi_node, shape)
        home = pp.decode_key(key_k, shape)
        return st.pushback_from_corners(
            list(corners), *(c / dx - h.to(torch.float32)
                             for c, h in zip((spx, spy, spz), home)))

    row(ROWS[20], pushback_kernel)
    ms_g, ms_k = rows[-2]["wall_ms"], rows[-1]["wall_ms"]
    log(f"    pushback A/B: gather {ms_g:.2f} ms vs kernel {ms_k:.2f} ms")
    finite = bool(torch.isfinite(sums).all())
    log(f"{'TOTAL particle work':28s} {total:9.2f} ms")
    return {"check": "pallas_engine_probe", "res": res, "particles": n,
            "rows": rows, "particle_work_wall_ms": total,
            "particle_work_device_ms": total_dev,
            "pass_b_plan_wall_ms": plan_b, "stale_pass_a_wall_ms": stale_total,
            "b_prime": b_prime, "stale_pass_a": stale,
            "ok": finite}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, n=4_100_000, res=128))
