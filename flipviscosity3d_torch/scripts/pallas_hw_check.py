"""Smoke gate of the particle engine's kernels against plain oracles.

    python -m flipviscosity3d_torch.scripts.pallas_hw_check [--device cpu]

Counterpart of the JAX package's scripts/pallas_hw_check.py: at 32^3 with
2 * 32^3 seeded particles it holds

- the P2G scatter's weight sum of lane 4 (the u face at offset (0, 0, 0))
  against a dense per-cell segment sum of Wyvill weights, rtol 1e-4 /
  atol 1e-5;
- table_fields' occupancy against min(particles in the cell, cap);
- detile of those sums viewed tile-major against the sums themselves,
  exactly;
- gather_rows at 108 and 54 columns against a plain take of the image,
  exactly (a copy; the JAX script allows 2e-6 for its MXU passes).

Exits 1 on any mismatch. On the card the wrappers launch the CUDA kernels;
with --device cpu they take the plain versions.
"""

from __future__ import annotations

import sys

import torch

from ..ops import pallas_particles as pp
from . import main, resolve_device


def run(device="cuda", res: int = 32, cap: int = 8, seed: int = 7,
        tamper=None, log=print) -> dict:
    """The checks above -> {"ok", "checks": [{"check", "ok", ...}]}.
    `tamper`, if given, maps each gather image to the one the kernel is
    handed, while the oracle reads the untouched image: a gate that passes
    a tampered image does not bite."""
    dev = resolve_device(device)
    dx = 1.0 / res
    shape = (res, res, res)
    n = 2 * res ** 3
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pos = 0.02 + 0.96 * torch.rand((n, 3), generator=gen, device=dev)
    vel = torch.randn((n, 3), generator=gen, device=dev)
    log(f"device={dev} res={res} n={n}")
    stream = pp.tiled_sort(pos, vel, dx, shape)
    checks = []

    sums, table = pp.scatter_p2g_table(stream.pos, stream.vel, stream.key,
                                       stream.rank, shape, dx, cap)
    sums4 = sums.reshape(*shape, -1)[..., :pp.N_P2G]
    ii, jj, kk = (c.long() for c in pp.decode_key(stream.key, shape))
    sp = stream.pos.double()
    fx = ii.double() * dx - sp[:, 0]
    fy = jj.double() * dx - (sp[:, 1] - 0.5 * dx)
    fz = kk.double() * dx - (sp[:, 2] - 0.5 * dx)
    d2 = fx ** 2 + fy ** 2 + fz ** 2
    wgt = torch.where(
        d2 < dx * dx,
        1 - (4 / 9 / dx ** 6) * d2 ** 3 + (17 / 9 / dx ** 4) * d2 ** 2
        - (22 / 9 / dx ** 2) * d2, torch.zeros_like(d2)).float()
    want = torch.zeros(res ** 3, device=dev).index_add_(
        0, stream.key.long(), wgt)[stream.key.long()]
    got = sums4[ii, jj, kk, 4]
    err = float((got - want).abs().max())
    checks.append({
        "check": "scatter lane 4 vs the dense Wyvill segment sum",
        "max_abs_err": err,
        "ok": bool(torch.isfinite(sums).all()) and bool(
            torch.allclose(got, want, rtol=1e-4, atol=1e-5))})

    fpx = pp.table_fields(table, cap)[0]
    cell_std = (ii * res + jj) * res + kk
    in_cell = torch.bincount(cell_std, minlength=res ** 3)
    checks.append({
        "check": "table_fields occupancy",
        "ok": bool(((fpx < 1e7).sum(dim=0)
                    == torch.clamp(in_cell, max=cap)).all())})

    tiled = pp.to_tile_major(sums4)
    checks.append({
        "check": "detile of the tile-major sums equals the sums",
        "ok": bool(torch.equal(pp.detile(tiled, shape), sums4))})
    del tiled

    n_tiles = res ** 3 // pp.W
    assert int(stream.key.max()) < n_tiles * pp.W   # the kernel does not check
    for n_cols in (108, 54):
        cols = torch.randn((n_tiles, n_cols, pp.W), generator=gen, device=dev)
        given = cols if tamper is None else tamper(cols)
        rows = pp.gather_rows(stream.key, None, given)
        want_r = cols.permute(0, 2, 1).reshape(-1, n_cols)[stream.key.long()]
        checks.append({"check": f"gather_rows ({n_cols} cols) vs a plain take",
                       "ok": bool(torch.equal(rows, want_r))})

    for c in checks:
        log(f"{c['check']}: {'OK' if c['ok'] else 'FAIL'}")
    ok = all(c["ok"] for c in checks)
    log("hw gate: ALL OK" if ok else "hw gate: FAILED")
    return {"check": "pallas_hw_check", "res": res, "particles": n, "ok": ok,
            "checks": checks}


if __name__ == "__main__":
    sys.exit(main(run, __doc__, res=32))
