"""The stream (and table) engine's particle passes of one substep.

    python -m flipviscosity3d_torch.scripts.particle_microbench
        [--device cpu] [--res 128] [--fill 0.25] [--np 4111806]
        [--with-table]

Counterpart of the JAX package's scripts/particle_microbench.py (its RES,
FILL, NP and WITH_TABLE are the flags): np particles (8 * fill * res^3
where np <= 0) drawn by np.random.default_rng(0) as the JAX script draws
them (uniform in [0.02, 0.98), y scaled by fill; velocities 0.5 N(0, 1)),
grids at rest and no solid, and the particle side of a substep with the
grid pipeline left out: per row the stream engine's stream_sort (pass A),
p2g_sdf_stream, sample_mac_at of 2 grids, and the midpoint sample of one
grid plus the solid pushback; with --with-table first the table engine's
build_buckets (pass A, with its overflow), p2g_and_sdf, and its samples of
2 grids plus gather_results. These engines run plain PyTorch: no kernel.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import SimConfig
from ..ops import particle_grid as pg
from ..ops import stream_transfers as st
from ..ops.buckets import build_buckets, gather_results
from ..ops.stream import stream_sort
from . import main, resolve_device, stage

ROWS = ("stream: stream_sort (pass A)", "stream: p2g_sdf_stream",
        "stream: sample_mac x2 grids", "stream: midpoint sample + pushback")
TABLE_ROWS = ("table: build_buckets (pass A)", "table: p2g_and_sdf",
              "table: g2p x2 grids + gather6")


def inputs(res: int, n: int, fill: float):
    """(pos, vel) numpy f32 of particle_microbench.py:79-85."""
    rng = np.random.default_rng(0)
    if n <= 0:
        n = int(8 * fill * res ** 3)
    pos = rng.uniform(0.02, 0.98, size=(n, 3)).astype(np.float32)
    pos[:, 1] *= fill
    vel = (rng.normal(size=(n, 3)).astype(np.float32) * 0.5)
    return pos, vel


def _payload6(p, v):
    return tuple(p.unbind(1)) + tuple(v.unbind(1))


def rest_grids(cfg, dev):
    """The JAX script's grids at rest and empty solid: (u, v, w, solid
    cell SDF, node SDF) (particle_microbench.py:87-92)."""
    return (torch.zeros(cfg.u_shape, device=dev),
            torch.zeros(cfg.v_shape, device=dev),
            torch.zeros(cfg.w_shape, device=dev),
            torch.ones(cfg.grid_shape, device=dev),
            torch.ones(cfg.node_shape, device=dev))


def stream_calls(pos, vel, cfg):
    """The four stream-engine passes of the rows ROWS: the first makes the
    stream, the other three take it."""
    shape, dx = cfg.grid_shape, cfg.dx
    u, v, w, solid_phi, node_phi = rest_grids(cfg, pos.device)
    face_shapes = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    return (
        lambda: stream_sort(pos, _payload6(pos, vel), dx, shape),
        lambda s: st.p2g_sdf_stream(s, shape, dx, cfg.particle_radius,
                                    solid_phi, face_shapes),
        lambda s: st.sample_mac_at(*s.sorted[:3], s.key, [u, u], [v, v],
                                   [w, w], dx, shape),
        lambda s: (st.sample_mac_at(*s.sorted[:3], s.key, [u], [v], [w],
                                    dx, shape),
                   st.solid_pushback_at(*s.sorted[:3], s.key, node_phi, dx,
                                        shape)),
    )


def run(device="cuda", res: int = 128, fill: float = 0.25,
        np_: int = 4_111_806, with_table: bool = False, log=print) -> dict:
    dev = resolve_device(device)
    cfg = SimConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res)
    shape, dx = cfg.grid_shape, cfg.dx
    pos_np, vel_np = inputs(res, np_, fill)
    pos = torch.from_numpy(pos_np).to(dev)
    vel = torch.from_numpy(vel_np).to(dev)
    n = int(pos.shape[0])
    log(f"# {res}^3, {n} particles, cap {cfg.bucket_capacity}")
    calls = stream_calls(pos, vel, cfg)
    rows = []
    overflow = None
    if with_table:
        u, v, w, solid_phi, _ = rest_grids(cfg, dev)
        face_shapes = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
        r, tbl = stage(TABLE_ROWS[0], lambda: build_buckets(
            pos, _payload6(pos, vel), dx, shape, cfg.bucket_capacity), dev,
            log)
        overflow = int(tbl.n_overflow)
        log(f"#   overflow: {overflow}")
        rows.append(r)
        rows.append(stage(TABLE_ROWS[1], lambda: pg.p2g_and_sdf(
            tbl, shape, dx, cfg.particle_radius, solid_phi, face_shapes),
            dev, log)[0])
        rows.append(stage(TABLE_ROWS[2], lambda: (
            pg.sample_mac_at_table(tbl, u, v, w, dx),
            pg.sample_mac_at_table(tbl, u, v, w, dx),
            gather_results(tbl, tbl.fields)), dev, log)[0])
        del tbl
    r, strm = stage(ROWS[0], calls[0], dev, log)
    rows.append(r)
    outs = []
    for name, call in zip(ROWS[1:], calls[1:]):
        r, out = stage(name, lambda call=call: call(strm), dev, log)
        rows.append(r)
        outs.append(out)
    phi = outs[0][0]
    finite = bool(torch.isfinite(phi).all())
    return {"check": "particle_microbench", "res": res, "particles": n,
            "table_overflow": overflow, "rows": rows, "ok": finite}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=128, fill=0.25, np_=4_111_806,
                  with_table=False))
