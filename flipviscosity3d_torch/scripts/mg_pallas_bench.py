"""The V-cycle of the K3 / K4 kernels against the plain cycle, and its time.

    python -m flipviscosity3d_torch.scripts.mg_pallas_bench [--device cpu]
        [--res 128] [--k 50]

Counterpart of the JAX package's scripts/mg_pallas_bench.py (its RES and K
are --res and --k). The JAX script compares its Pallas V-cycle with its XLA
one. In the port mg_backend chooses only where the level operators are
stored (solvers/multigrid.py: f32 under "xla", bf16 under "pallas" on the
card, f32 on the CPU), and K3 mg_down / K4 mg_up run under every backend.
So for each backend the cycle multigrid.v_cycle runs (K3 / K4 on the card,
their plain versions on the CPU) is held against v_cycle_plain, the
same recursion through mg_down_ref / mg_up_ref on the same hierarchy:

- equality at (16, 16, 16) and (3, 17, 18, 17) on the JAX script's
  default_rng(7) operators, printing the largest difference of the two
  cycles under each backend (0 where K3 / K4 are exact, as on the card)
  and of the "pallas" cycle from the "xla" one (the bf16 storage's);
- ms per cycle, chains of k cycles at res^3 and (3, res+1, res+1, res+1)
  under both backends. As in the JAX script, each cycle takes the last
  one's output for its right-hand side, so the chain can overflow to inf
  (each row says whether it stayed finite); only the equality decides
  "ok".
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import SimConfig
from ..ops import pallas_mg as pm
from ..solvers import multigrid as mg
from . import main, resolve_device, stage

OMEGA, SCALE = 0.8, 1.4
BACKENDS = ("xla", "pallas")
CHECK_SHAPES = ((16, 16, 16), (3, 17, 18, 17))


def operators(rng, shape, hi: float):
    """(diag, links, b) numpy f32 as the JAX script draws them: diag in
    [1, 2), links in [0, hi), b normal."""
    diag = rng.uniform(1, 2, shape).astype(np.float32)
    links = tuple(rng.uniform(0, hi, shape).astype(np.float32)
                  for _ in range(3))
    b = rng.normal(size=shape).astype(np.float32)
    return diag, links, b


def hierarchy(diag, links, res: int, dev, **cfg_fields):
    """multigrid.build_hierarchy of numpy operators on `dev` under a
    res^3 SimConfig with `cfg_fields`."""
    cfg = SimConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res,
                    **cfg_fields)
    t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
    return mg.build_hierarchy(t(diag), tuple(t(lk) for lk in links), cfg)


def kernel_cycle(hier, b):
    """One V(1,1) cycle as the solvers run it (K3 / K4 on the card)."""
    return mg.v_cycle(hier, b, 1, 1, OMEGA, SCALE)


def v_cycle_plain(hier, b, omega, scale):
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


def plain_cycle(hier, b):
    squeeze = b.ndim == 3
    out = v_cycle_plain(hier, b[None] if squeeze else b, OMEGA, SCALE)
    return out[0] if squeeze else out


def run(device="cuda", res: int = 128, k: int = 50, log=print) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    checks = []
    for shape in CHECK_SHAPES:
        diag, links, b = operators(rng, shape, 0.25)
        tb = torch.from_numpy(b).to(dev)
        outs = {}
        for backend in BACKENDS:
            h = hierarchy(diag, links, 16, dev, mg_backend=backend)
            outs[backend] = kernel_cycle(h, tb)
            diff = float((outs[backend] - plain_cycle(h, tb)).abs().max())
            checks.append({"shape": list(shape), "backend": backend,
                           "storage": str(h.ops[0][0].dtype),
                           "kernel_vs_plain": diff, "ok": diff == 0.0})
            log(f"{shape} {backend} cycle diff vs plain {diff}")
        log(f"{shape} cycle diff pallas vs xla "
            f"{float((outs['pallas'] - outs['xla']).abs().max())}")
        checks[-1]["pallas_vs_xla"] = float(
            (outs["pallas"] - outs["xla"]).abs().max())

    rows = []
    for shape in ((res,) * 3, (3,) + (res + 1,) * 3):
        diag, links, b = operators(rng, shape, 0.3)
        tb = torch.from_numpy(b).to(dev)
        for backend in BACKENDS:
            h = hierarchy(diag, links, res, dev, mg_backend=backend)

            def chain(h=h):
                x = tb
                for _ in range(k):
                    x = kernel_cycle(h, x)
                return x

            r, x = stage(f"{shape} {backend} v_cycle x{k}", chain, dev, log)
            r.update(shape=list(shape), backend=backend, k=k,
                     ms_per_cycle=r["wall_ms"] / k,
                     device_ms_per_cycle=(None if r["device_ms"] is None
                                          else r["device_ms"] / k),
                     finite=bool(torch.isfinite(x).all()))
            rows.append(r)
    return {"check": "mg_pallas_bench", "res": res, "k": k,
            "checks": checks, "rows": rows,
            "ok": all(c["ok"] for c in checks)}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=128, k=50))
