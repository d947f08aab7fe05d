"""One substep of the slab pipeline at 512^3 (BASELINE config 5's scale).

    python -m flipviscosity3d_torch.scripts.readiness512 [--device cpu]
        [--res 512] [--npart 2000000] [--ndev 8] [--isize N]

Counterpart of the JAX package's scripts/readiness512.py (its RES, NPART,
NDEV and ISIZE are the flags): parallel/shard_step.advance_sharded for one
substep of dt 1e-4 over ndev slab ranks (parallel/sharding.make_mesh: a
DistGroup when torch.distributed is initialised, else a LocalGroup of
ndev rank-threads on the one device), on an (isize, res, res) grid under
the default SimConfig with viscosity 1, the analytic inverted-box solid
(readiness256.analytic_boundary_sdf) and npart particles drawn by
np.random.default_rng(1) as the JAX script draws them (uniform in [2/res,
isize/res - 2/res] x [2/res, 0.25] x [2/res, 1 - 2/res]); make_spec with
cap_factor 2. It checks that no particle was lost and every position is
finite, and gives the JAX script's line (res, isize, n_devices,
n_particles, slab_shape, substeps, both iteration counts, the seconds of
the substep) plus the device's peak memory.

isize below res keeps the slab shape of the full grid with fewer slabs:
isize = ndev * 64 gives config 5's exact slabs, (64 + 2H, 512, 512), as
the JAX script's docstring says for a host that cannot hold all eight. All
ranks of a LocalGroup live on the one device, so their slabs add up there.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import SimConfig
from ..parallel import shard_step as sh
from ..parallel.sharding import make_mesh
from . import main, resolve_device
from .readiness256 import readiness_sim

DT = 1e-4


def particles(res: int, isize: int, npart: int) -> np.ndarray:
    """readiness512.py:100-104's draw."""
    rng = np.random.default_rng(1)
    m = 2.0 / res
    xhi = isize / res - m
    return rng.uniform([m, m, m], [xhi, 0.25, 1.0 - m],
                       (npart, 3)).astype(np.float32)


def setup(dev, res: int, npart: int, ndev: int, isize=None):
    """(ShardedSim, SimConfig, SlabSpec, group) of the readiness scene; the
    global state is dropped once it is cut into slabs."""
    isize = res if isize is None else isize
    cfg = SimConfig(isize=isize, jsize=res, ksize=res, dx=1.0 / res)
    pos = torch.from_numpy(particles(res, isize, npart)).to(dev)
    state = readiness_sim(dev, cfg, 1.0, pos).state
    spec = sh.make_spec(cfg, ndev, cap_factor=2.0, n_particles=npart)
    group = make_mesh(ndev, dev)
    return sh.shard_simstate(state, cfg, spec, group), cfg, spec, group


def _alive(ss) -> int:
    """Alive particles over every rank (all_reduce under a DistGroup)."""
    count = ss.alive.sum()
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(count)
    return int(count)


def run(device="cuda", res: int = 512, npart: int = 2_000_000,
        ndev: int = 8, isize=None, log=print) -> dict:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ss, cfg, spec, group = setup(dev, res, npart, ndev, isize)
    log(f"state built: ({cfg.isize},{res},{res}), {npart} particles, "
        f"{ndev} slabs of {spec.B} + 2 x {spec.H} rows")
    t0 = time.perf_counter()
    ss, diag = sh.advance_sharded(ss, DT, cfg, spec, group)
    seconds = time.perf_counter() - t0
    alive = _alive(ss)
    pos, _ = sh.gather_particles(ss)
    finite = bool(np.isfinite(pos).all())
    out = dict(
        res=res, isize=cfg.isize, n_devices=ndev, n_particles=npart,
        slab_shape=[spec.B + 2 * spec.H, res, res], substeps=diag.substeps,
        pressure_iters=diag.pressure_iterations,
        viscosity_iters=diag.viscosity_iterations,
        first_substep_s=seconds, alive=alive, finite=finite,
        migration_lost=diag.migration_lost,
        peak_gb=(torch.cuda.max_memory_allocated() / 1e9 if on_card
                 else None))
    if alive != npart:
        log(f"lost particles: {alive} != {npart}")
    if not finite:
        log("non-finite positions")
    return {"check": "readiness512", **out,
            "ok": alive == npart and finite}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=512, npart=2_000_000, ndev=8,
                  isize=(int, None)))
