"""The slab groups the multi-device pipeline runs on.

Counterpart of the mesh constructors of flipviscosity3d_tpu/parallel/
sharding.py (`make_mesh`, `make_slab_mesh`). Each returns a group of slab
ranks (parallel/collectives.py) in host-major slab order (docs/DCN.md:
slabs [h*C, (h+1)*C) on host h):

- under an initialised torch.distributed, the process group's ranks as a
  DistGroup (slab s = rank s; launchers number ranks host-major);
- otherwise a LocalGroup: n rank-threads on one device (the card unless
  the caller names another), standing in for the devices as the JAX
  tests' forced host devices do.

The JAX module's auto-SPMD helpers (grid_sharding, state_shardings,
shard_state) have no counterpart yet: no torch partitioner runs the port's
custom kernels, so theirs is a design of its own (ROADMAP Queue 1).
"""

from __future__ import annotations

import torch

from .collectives import DistGroup, LocalGroup


def _group(n, device):
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        g = DistGroup(device)
        if n is not None and n != g.size:
            raise RuntimeError(
                f"need {n} ranks, the process group has {g.size}")
        return g
    if n is None:
        n = max(torch.cuda.device_count(), 1)
    return LocalGroup(n, "cuda" if device is None else device)


def make_mesh(n_devices: int | None = None, device=None):
    """A group of n_devices slab ranks (all of the process group's, or one
    per CUDA device, when None)."""
    return _group(n_devices, device)


def make_slab_mesh(n_hosts: int, chips_per_host: int, device=None):
    """The multi-host slab layout of docs/DCN.md: n_hosts * chips_per_host
    ranks, host-major, so that every neighbour exchange but the n_hosts - 1
    at host boundaries stays on a host. The slab pipeline is the same on
    it; only placement differs."""
    return _group(n_hosts * chips_per_host, device)
