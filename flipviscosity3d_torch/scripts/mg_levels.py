"""Times the V-cycle kernels K3 mg_down and K4 mg_up at every level of both
solves' hierarchies, for one copy of the package, so that two copies (a
commit and its parent) can be compared on one card in one call:

    python3 flipviscosity3d_torch/scripts/mg_levels.py [--root DIR]
        [--res 128] [--device cuda|cpu] [--label NAME]

imports flipviscosity3d_torch from DIR (default: the checkout that holds
this file), builds each hierarchy with its multigrid.build_hierarchy from a
random diagonally dominant fine operator (pressure (1, res, res, res),
viscosity (3, res+1, res+1, res+1); the default config, so the levels are
stored in bf16 on the card), and prints one JSON line per level above the
coarsest: each kernel's device time back to back (`ms`) and with the L2
cache flushed before each launch (`ms_cold`), its bound (bytes read and
written once over 3.35 TB/s), and whether it is torch.equal to its plain
version. Runs the file as a script (not with -m), so that DIR's package is
the one imported; uses only functions both copies have.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 256 << 20
HEAD_START_CYCLES = 2_000_000
HERE = os.path.dirname(os.path.abspath(__file__))


def device_ms(torch, fn, flush=None, count: int = 10,
              repeats: int = 5) -> float:
    """Median device milliseconds of one fn() call over `repeats` batches
    queued behind torch.cuda._sleep (the host's launch cost stays out):
    `count` calls back to back, or one call after flush() (outside the
    events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        if flush is not None:
            flush()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        calls = 1 if flush is not None else count
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def run(root: str, res: int, device: str, label: str, seed: int = 0,
        log=print) -> list:
    """One JSON-ready dict per level (see the module docstring)."""
    sys.path.insert(0, root)
    import torch

    from flipviscosity3d_torch.config import SimConfig
    from flipviscosity3d_torch.ops import pallas_mg as pm
    from flipviscosity3d_torch.solvers import multigrid as mg

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cfg = SimConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res)
    flush_buf = torch.empty(FLUSH_BYTES // 4 if on_card else 1, device=dev)
    where = card() if on_card else "cpu"
    lines = []
    for system, fine in (("pressure", (1, res, res, res)),
                         ("viscosity", (3,) + (res + 1,) * 3)):
        diag = 1.0 + torch.rand(fine, generator=gen, device=dev)
        links = tuple(0.25 * torch.rand(fine, generator=gen, device=dev)
                      for _ in range(3))
        hier = mg.build_hierarchy(diag, links, cfg)
        del diag, links
        for lvl, (d, lk) in enumerate(hier.ops):
            shape = tuple(d.shape)
            b = torch.randn(shape, generator=gen, device=dev)
            xc = torch.randn(pm.coarse_shape(shape), generator=gen,
                             device=dev)
            omega, scale = cfg.mg_omega, cfg.mg_coarse_scale
            x, rc = pm.mg_down(d, lk, b, omega)
            xr, rcr = pm.mg_down_ref(d, lk, b, omega)
            up = (d, lk, b, xr, xc, omega, scale)
            out = pm.mg_up(*up)
            op_bytes = 4 * d.numel() * d.element_size()
            cells = b.numel()
            line = {"label": label, "system": system, "level": lvl,
                    "shape": list(shape), "operator": str(d.dtype)}
            for name, fn, equal, nbytes in (
                    ("mg_down", lambda: pm.mg_down(d, lk, b, omega),
                     torch.equal(x, xr) and torch.equal(rc, rcr),
                     op_bytes + 8 * cells + 4 * rc.numel()),
                    ("mg_up", lambda: pm.mg_up(*up),
                     torch.equal(out, pm.mg_up_ref(*up)),
                     op_bytes + 12 * cells + 4 * xc.numel())):
                rec = {"equal": bool(equal),
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
                if on_card:
                    rec["ms"] = device_ms(torch, fn)
                    rec["ms_cold"] = device_ms(torch, fn, flush_buf.zero_)
                    rec["cold_over_bound"] = rec["ms_cold"] / rec["bound_ms"]
                line[name] = rec
            line["card"] = where
            log(json.dumps(line))
            lines.append(line)
            del b, xc, x, rc, xr, rcr, out
        del hier
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    lines = run(os.path.abspath(args.root), args.res, args.device,
                args.label or args.root)
    return 0 if all(ln[k]["equal"] for ln in lines
                    for k in ("mg_down", "mg_up")) else 1


if __name__ == "__main__":
    sys.exit(main())
