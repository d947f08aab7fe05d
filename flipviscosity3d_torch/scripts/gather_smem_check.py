"""gather_rows alone at the bench scale, exact against its image and timed.

    python -m flipviscosity3d_torch.scripts.gather_smem_check \\
        [--device cpu] [--res 128] [--n 4111806]

Counterpart of the JAX package's scripts/gather_smem_check.py, which proved
that its gather kernel compiles at 4M particles (the size of its
scalar-prefetch tables) without the full step. That script is stale: it
hands `spans` and a W-major (n_tiles, W, F) image to a function that now
takes a visit plan and an F-major image. This module ports what
gather_rows is today: sorted tile-major keys spread like the bench pool,
an F-major (n_tiles, f_pad, W) image with the pad lanes zero, at 108 and
54 logical columns, every row held exactly against the image, then timed
(time_ms of this package). Exits 1 on any mismatch.
"""

from __future__ import annotations

import sys

import torch

from ..ops import pallas_particles as pp
from . import main, pool_keys, resolve_device, time_ms


def run(device="cuda", res: int = 128, n: int = 4_111_806, seed: int = 0,
        batch_ms: float = 50.0, log=print) -> dict:
    """-> {"ok", "res", "particles", "checks": [{"n_cols", "ok", "ms"}]}."""
    dev = resolve_device(device)
    n_tiles = (res // 8) ** 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = pool_keys(n, res, gen, dev)
    assert int(keys.max()) < n_tiles * pp.W   # gather_rows does not check
    checks = []
    for n_cols in (108, 54):
        f_pad = -(-n_cols // 8) * 8
        cols = torch.zeros((n_tiles, f_pad, pp.W), device=dev)
        cols[:, :n_cols] = 2.0 * torch.rand(
            (n_tiles, n_cols, pp.W), generator=gen, device=dev) - 1.0
        rows = pp.gather_rows(keys, None, cols, n_cols)
        ok = tuple(rows.shape) == (n, n_cols) and bool(
            torch.equal(rows, pp.gather_rows_ref(keys, None, cols, n_cols)))
        del rows
        ms = time_ms(lambda: pp.gather_rows(keys, None, cols, n_cols), dev,
                     batch_ms)
        log(f"gather_rows n_cols={n_cols}: "
            f"{'exact OK' if ok else 'MISMATCH'}, {ms:.3f} ms/call warm")
        checks.append({"n_cols": n_cols, "ok": ok, "ms": ms})
        del cols
    return {"check": "gather_smem_check", "res": res, "particles": n,
            "ok": all(c["ok"] for c in checks), "checks": checks}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=128, n=4_111_806))
