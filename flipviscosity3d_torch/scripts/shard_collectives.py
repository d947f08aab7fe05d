"""Collective audit of the slab substep.

    python -m flipviscosity3d_torch.scripts.shard_collectives \\
        [--device cpu] [--res 32] [--ndev 4]

Counterpart of the JAX package's scripts/shard_collectives.py, which
compiles advance_sharded and reads the collectives out of the HLO. Here
the slab group records every collective call of rank 0 (kind, shape,
bytes sent, the calling function) while advance_sharded runs one frame of
the JAX script's scene (a box of liquid at rest, viscosity 1.5: its first
frame is one substep), on a LocalGroup of --ndev rank-threads, once with
Jacobi and once with multigrid preconditioners. It prints one JSON line:
per preconditioner the calls grouped by (kind, shape, caller) with their
count and bytes, the totals by kind, and two checks, as the JAX audit
makes them:

- under Jacobi the stencil path is halo exchanges and reductions: no
  all-gather at all;
- under multigrid the only all-gathers are the slab V-cycle's gathered
  tail (slab_mg._gather_rows).

Exits 1 if a check fails.
"""

from __future__ import annotations

import sys

from ..core.sim import FluidSimulation
from ..io.trianglemesh import box_mesh
from ..parallel import shard_step as sh
from ..parallel.collectives import LocalGroup
from . import main, resolve_device

# the one function allowed to all-gather (the slab V-cycle's tail)
TAIL_GATHER = "_gather_rows"


def audit(dev, res: int, ndev: int, preconditioner: str) -> dict:
    """One frame (one substep from rest) on ndev slabs, rank 0's calls."""
    sim = FluidSimulation(dev)
    sim.initialize(res, res, res, 1.0 / res,
                   pressure_preconditioner=preconditioner,
                   viscosity_preconditioner=preconditioner)
    sim.add_liquid(box_mesh((0.2, 0.25, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(1.5)
    sim.set_gravity(0.0, -9.81, 0.0)
    cfg, state = sim.cfg, sim.state
    spec = sh.make_spec(cfg, ndev, n_particles=int(state.pos.shape[0]))
    group = LocalGroup(ndev, dev)
    ss = sh.shard_simstate(state, cfg, spec, group)
    trace = group.ranks[0].trace = []
    _, d = sh.advance_sharded(ss, 0.01, cfg, spec, group)
    rows = {}
    for kind, shape, nbytes, caller in trace:
        r = rows.setdefault((kind, shape, caller), [0, 0])
        r[0] += 1
        r[1] += nbytes
    calls = [{"kind": k, "shape": list(s), "caller": c, "calls": n,
              "bytes": b} for (k, s, c), (n, b) in sorted(rows.items())]
    totals = {}
    for c in calls:
        t = totals.setdefault(c["kind"], {"calls": 0, "bytes": 0})
        t["calls"] += c["calls"]
        t["bytes"] += c["bytes"]
    gathers = [c for c in calls if c["kind"] == "all_gather"]
    if preconditioner == "jacobi":
        ok = not gathers
    else:
        ok = all(c["caller"] == TAIL_GATHER for c in gathers)
    return {"preconditioner": preconditioner, "substeps": d.substeps,
            "B": spec.B, "H": spec.H, "totals": totals, "calls": calls,
            "all_gathers": sum(c["calls"] for c in gathers), "ok": ok}


def run(device="cuda", res: int = 32, ndev: int = 4) -> dict:
    dev = resolve_device(device)
    audits = [audit(dev, res, ndev, p) for p in ("jacobi", "multigrid")]
    return {"res": res, "ndev": ndev, "audits": audits,
            "ok": all(a["ok"] for a in audits)}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=32, ndev=4))
