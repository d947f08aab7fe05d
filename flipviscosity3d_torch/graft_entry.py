"""Entry points of a compile check and a multi-device dry run.

Counterpart of the JAX repo's __graft_entry__.py:

- `entry(device)` -> (fn, example_args): fn(state, dt) runs one
  CFL-substepped frame of core.step.advance on a tiny scene (16^3, a box
  of liquid, viscosity 2.0, 4096 particles) and returns (positions, u,
  substeps).
- `dryrun_multichip(n_devices, device)` runs the two multi-device forms
  and raises unless each held: the slab pipeline
  (parallel/shard_step.advance_sharded, three frames on n slab ranks, a +x
  drift and +x gravity, so that particles migrate across slab faces:
  substeps ran, no migration overflow, no particle lost, some migrated,
  finite positions), then the placed single-device step
  (parallel/sharding.shard_state and advance_placed, one frame at 16^3 of
  2048 particles: substeps ran, finite positions). It prints the JAX
  dry run's two "dryrun_multichip ... OK" lines.

The slab ranks are a LocalGroup of n rank-threads on `device` (the card
unless the caller names the CPU), as the JAX dry run's forced CPU devices
stand in for chips. Both halves run the scene's configuration, whose
particle engine is "table" (the default), so the slab half runs the slab
pipeline's "stream" engine, as the JAX dry run does.

    python -m flipviscosity3d_torch.graft_entry [N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import step as step_mod
from .core.sim import FluidSimulation
from .io.trianglemesh import box_mesh
from .parallel import shard_step as sh
from .parallel.collectives import LocalGroup
from .parallel.sharding import advance_placed, shard_state, unplace


def _tiny_sim(res=16, n_particles=4096, seed=0, device="cuda"):
    """A small SimState on `device`: the box of liquid's particles trimmed
    to n_particles, or padded with uniform rows of default_rng(seed) in
    [0.25, 0.55)^3; velocities zero -> (sim, state)."""
    sim = FluidSimulation(device)
    sim.initialize(res, res, res, 1.0 / res)
    sim.add_liquid(box_mesh((0.2, 0.2, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(2.0)
    state = sim.state
    rng = np.random.default_rng(seed)
    pos = state.pos.cpu().numpy()
    if len(pos) >= n_particles:
        pos = pos[:n_particles]
    else:
        extra = rng.uniform(0.25, 0.55, size=(n_particles - len(pos), 3))
        pos = np.concatenate([pos, extra.astype(np.float32)])
    dev = state.pos.device
    state = state.replace(
        pos=torch.from_numpy(np.ascontiguousarray(pos)).to(dev),
        vel=torch.zeros((n_particles, 3), dtype=torch.float32, device=dev))
    return sim, state


def entry(device="cuda"):
    """(fn, example_args): one CFL-substepped frame of the flagship
    configuration (FLIP, variational pressure and viscosity) on the tiny
    scene."""
    sim, state = _tiny_sim(device=device)
    cfg = sim.cfg

    def fn(state, dt):
        new_state, diag = step_mod.advance(state, dt, cfg)
        return new_state.pos, new_state.u, diag.substeps

    return fn, (state, 0.01)


def dryrun_multichip(n_devices: int, device="cuda", log=print) -> dict:
    """The slab pipeline on n_devices slab ranks, then the placed
    single-device step; raises AssertionError unless each held. Returns the
    two halves' numbers."""
    # ---- the slab pipeline ----
    res = 48 if n_devices == 8 else max(16, 6 * n_devices)
    res += (-res) % n_devices
    sim, state = _tiny_sim(res=res, n_particles=4096, device=device)
    cfg = sim.cfg
    dev = state.pos.device
    # gravity along the split i axis and a +x drift toward the near slab
    # face: the first 4096 seeded particles fill one i-row of cells, just
    # short of a face, so three frames sweep most of them across;
    # mig = 4096 rows a direction keeps drops at zero
    vel = torch.zeros_like(state.vel)
    vel[:, 0] = 1.0
    state = state.replace(
        gravity=torch.tensor([9.81, 0.0, 0.0], dtype=torch.float32,
                             device=dev), vel=vel)
    # the cloud lies on a couple of slabs: size each slab for that skew
    spec = sh.make_spec(cfg, n_devices, cap_factor=2.0 * n_devices,
                        n_particles=state.pos.shape[0], mig=4096)
    group = LocalGroup(n_devices, dev)
    ss = sh.shard_simstate(state, cfg, spec, group)
    occupancy0 = ss.alive.sum(dim=1).cpu().numpy()
    for _ in range(3):
        ss, diag = sh.advance_sharded(ss, 0.01, cfg, spec, group)
    occupancy1 = ss.alive.sum(dim=1).cpu().numpy()
    assert diag.substeps >= 1
    assert diag.bucket_overflow == 0, (
        f"migration buffer overflow dropped {diag.bucket_overflow} "
        "particles (raise spec.mig)")
    assert int(occupancy1.sum()) == int(occupancy0.sum()), "particles lost"
    migrated = int(np.abs(occupancy1 - occupancy0).sum()) // 2
    assert migrated > 0, (
        f"migration never fired (occupancy {occupancy0.tolist()} -> "
        f"{occupancy1.tolist()}) despite the inbound drift")
    pos_m, _ = sh.gather_particles(ss)
    assert np.isfinite(pos_m).all()
    slab = {"devices": n_devices, "res": res, "substeps": diag.substeps,
            "pressure_iterations": diag.pressure_iterations,
            "migrated": migrated, "occupancy": occupancy1.tolist()}
    log(f"dryrun_multichip slab OK: {n_devices} devices, "
        f"{diag.substeps} substeps, "
        f"pressure iters {diag.pressure_iterations}, "
        f"{migrated} particles migrated across slabs")

    # ---- the placed single-device step ----
    sim2, state2 = _tiny_sim(res=16, n_particles=2048, device=device)
    cfg2 = sim2.cfg
    group2 = LocalGroup(n_devices, dev)
    placed, placements = shard_state(state2, group2, cfg2)
    placed, diag2 = advance_placed(placed, placements, 0.01, cfg2, group2)
    assert diag2.substeps >= 1
    assert bool(torch.isfinite(unplace(placed, placements).pos).all())
    log(f"dryrun_multichip pjit OK: {n_devices} devices, "
        f"{diag2.substeps} substeps, "
        f"pressure iters {diag2.pressure_iterations}")
    return {"slab": slab,
            "placed": {"devices": n_devices, "substeps": diag2.substeps,
                       "pressure_iterations": diag2.pressure_iterations}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    from .scripts import resolve_device

    dryrun_multichip(args.n_devices, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
