"""The multigrid V-cycle's building blocks, timed at res^3.

    python -m flipviscosity3d_torch.scripts.mg_profile [--device cpu]
        [--res 128] [--k 50]

Counterpart of the JAX package's scripts/mg_profile.py (its RES and K are
--res and --k), on its default_rng(0) operators: per row, a chain of k
data-dependent applications of one piece (identity mul, the 7-point apply,
one smoothing sweep, pool_sum, prolong, a restrict + prolong round trip,
and the whole V(1,1) cycle under mg_max_levels 2, 3, 5 and 16, whose
levels run K3 mg_down / K4 mg_up on the card), first on the (res, res,
res) operator, then on the batched (3, res+2, res+2, res+2) one of the
viscosity blocks. A piece whose output has another shape is folded back
into its input's (x * 0.999 + sum(y) * 1e-12), as the JAX script does.

The JAX script folds the k applications into one jitted fori_loop, so its
identity row is the dispatch floor over k. The port's chain is a Python
loop of k launches, so its identity row is the launch floor of one
elementwise op: subtract it from the rows as the JAX script's header says.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.pallas_mg import apply_level, pool_sum, prolong
from ..solvers import multigrid as mg
from . import main, resolve_device, stage
from .mg_pallas_bench import (OMEGA, SCALE, hierarchy, kernel_cycle,
                              operators)

LEVELS = (2, 3, 5, 16)


def cycle_label(hier) -> str:
    return f"v_cycle L{len(hier.levels)}" + (
        " dense" if hier.coarse_inv is not None else " smooth")


def run(device="cuda", res: int = 128, k: int = 50, log=print) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []

    def chain(name, op, x0, **extra):
        def body():
            x = x0
            for _ in range(k):
                y = op(x)
                x = y if y.shape == x.shape else x * 0.999 + y.sum() * 1e-12
            return x

        r, _ = stage(name, body, dev, log, **extra)
        r["ms_per_op"] = r["wall_ms"] / k
        r["device_ms_per_op"] = (None if r["device_ms"] is None
                                 else r["device_ms"] / k)
        rows.append(r)

    for prefix, shape in (("", (res,) * 3), ("b ", (3,) + (res + 2,) * 3)):
        diag, links, b = operators(rng, shape, 0.3)
        t = lambda a: torch.from_numpy(a).to(dev)   # noqa: E731
        tb = t(b)
        level = mg._level(t(diag), tuple(t(lk) for lk in links))
        log(f"# {prefix}{shape} amortized op timings (k={k}; subtract the "
            "identity row = the launch floor)")
        chain(prefix + "identity mul", lambda x: x * 1.000001, tb)
        chain(prefix + "7pt apply",
              lambda x: apply_level(level.diag, level.links, x), tb)
        chain(prefix + "smooth x1",
              lambda x: mg._smooth(level, x, tb, 1, OMEGA), tb)
        chain(prefix + "pool_sum", pool_sum, tb)
        chain(prefix + "prolong", lambda a: prolong(a, shape[-3:]),
              pool_sum(tb))
        if not prefix:
            chain("restrict+prolong round trip",
                  lambda x: x - 0.1 * prolong(pool_sum(x), shape), tb)
        for levels in LEVELS:
            h = hierarchy(diag, links, res, dev, mg_max_levels=levels)
            chain(prefix + cycle_label(h), lambda x, h=h: kernel_cycle(h, x),
                  tb, mg_max_levels=levels)
    return {"check": "mg_profile", "res": res, "k": k, "omega": OMEGA,
            "coarse_scale": SCALE, "rows": rows, "ok": True}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=128, k=50))
