"""The slab groups the multi-device pipeline runs on, and the placement of a
whole SimState over a group.

Counterpart of flipviscosity3d_tpu/parallel/sharding.py. The mesh
constructors (`make_mesh`, `make_slab_mesh`) return a group of slab ranks
(parallel/collectives.py) in host-major slab order (docs/DCN.md: slabs
[h*C, (h+1)*C) on host h):

- under an initialised torch.distributed, the process group's ranks as a
  DistGroup (slab s = rank s; launchers number ranks host-major);
- otherwise a LocalGroup: n rank-threads on one device (the card unless
  the caller names another), standing in for the devices as the JAX
  tests' forced host devices do.

The placement helpers (`grid_sharding`, `state_shardings`, `shard_state`)
follow the JAX module's rule exactly, array by array: a grid splits along
i into n equal pieces when n divides its first extent and is replicated
otherwise (so the I+1-row staggered and node grids can land differently
from the cell grids), the particle arrays split by index, gravity is
replicated. Where jax.device_put refuses an input (a particle count or a
first extent that n does not divide under a split placement, an array of
lower rank than its placement) `shard_state` raises ValueError; it never
pads.

What the JAX package does with a placed state is `jax.jit(advance,
in_shardings=..., out_shardings=...)`: XLA partitions the single-device
step. No torch partitioner runs the port's custom kernels, so
`advance_placed` does the same work replicated: it all-gathers the split
pieces (SlabGroup.all_gather), runs the single-device core.step.advance
once per process on the whole state, and splits the result by the same
placements. Its answer is the single-device one, bit for bit; its compute
is not partitioned. The port's partitioned step is the slab pipeline,
parallel/shard_step.advance_sharded.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import SimConfig
from ..core import step as step_mod
from ..core.state import SimState, SolidBoundary
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


# ---------------------------------------------------------------------------
# placement of a whole SimState (the JAX module's pjit helpers)
# ---------------------------------------------------------------------------

class Placement(NamedTuple):
    """Where an array lives on a group: "shard_i" splits its first axis
    into group.size equal pieces in rank order, "replicate" gives every
    rank all of it. `ndim` is the rank of a split array (the length of the
    JAX PartitionSpec: P(axis, None, None) is ("shard_i", 3), P(axis,
    None) ("shard_i", 2), P() ("replicate", 0))."""

    kind: str
    ndim: int = 0


REPLICATE = Placement("replicate")


def grid_sharding(group, shape) -> Placement:
    """A grid of `shape` splits along i when group.size divides shape[0],
    otherwise it is replicated (flipviscosity3d_tpu/parallel/sharding.py:67
    on the same rule, decided per array)."""
    if shape[0] % group.size == 0:
        return Placement("shard_i", len(shape))
    return REPLICATE


def state_shardings(group, cfg: SimConfig) -> SimState:
    """A SimState-shaped table of Placements: every grid by grid_sharding of
    its cfg shape, the particles split by index, gravity replicated."""
    parts = Placement("shard_i", 2)

    def g(shape):
        return grid_sharding(group, shape)

    return SimState(
        pos=parts,
        vel=parts,
        u=g(cfg.u_shape),
        v=g(cfg.v_shape),
        w=g(cfg.w_shape),
        solid=SolidBoundary(
            phi=g(cfg.node_shape),
            center_phi=g(cfg.grid_shape),
            weight_u=g(cfg.u_shape),
            weight_v=g(cfg.v_shape),
            weight_w=g(cfg.w_shape),
            solid_u=g(cfg.u_shape),
            solid_v=g(cfg.v_shape),
            solid_w=g(cfg.w_shape),
        ),
        viscosity=g(cfg.node_shape),
        gravity=REPLICATE,
    )


def _fields(state: SimState):
    """(path, value) of every leaf of a SimState-shaped table, solid
    flattened (the order of core.state's fields)."""
    for f in dataclasses.fields(SimState):
        v = getattr(state, f.name)
        if f.name == "solid":
            for g in dataclasses.fields(SolidBoundary):
                yield ("solid", g.name), getattr(v, g.name)
        else:
            yield (f.name,), v


def _build(leaves: dict) -> SimState:
    """The inverse of _fields: a SimState from {path: value}."""
    solid = SolidBoundary(**{p[1]: v for p, v in leaves.items()
                             if p[0] == "solid"})
    return SimState(solid=solid, **{p[0]: v for p, v in leaves.items()
                                    if p[0] != "solid"})


def _piece(x: torch.Tensor, place: Placement, rank: int, n: int, name):
    """Rank `rank`'s piece of x under `place` (a copy of its own, for a
    split; x itself, replicated)."""
    if place.kind == "replicate":
        return x
    if x.dim() < place.ndim:
        raise ValueError(f"{name}: a {x.dim()}-d array under a placement of "
                         f"{place.ndim} dimensions")
    if x.shape[0] % n:
        raise ValueError(f"{name}: its first extent {x.shape[0]} is not "
                         f"divisible by the group's {n} ranks")
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b].clone()


def _split(state: SimState, placements: SimState, group) -> list:
    """One SimState of pieces per rank this process drives, in the order
    of group.ranks, on the group's device."""
    places = dict(_fields(placements))
    leaves = {p: v.to(group.device) for p, v in _fields(state)}
    return [_build({p: _piece(v, places[p], r.rank, group.size,
                              ".".join(p))
                    for p, v in leaves.items()})
            for r in group.ranks]


def shard_state(state: SimState, group, cfg: SimConfig):
    """Place `state` on `group` under state_shardings -> (placed, the
    placements). `placed` is a list with one SimState per rank that this
    process drives (group.ranks, in order: every rank of a LocalGroup, the
    process's own of a DistGroup), each holding that rank's piece of every
    array on the group's device: its i-rows of a split grid, its rows of
    the particles, all of a replicated array (shared by the process's
    ranks). Raises ValueError where jax.device_put raises."""
    placements = state_shardings(group, cfg)
    return _split(state, placements, group), placements


def advance_placed(placed: list, placements: SimState, dt, cfg: SimConfig,
                   group):
    """One frame of core.step.advance on a placed state -> (placed, its
    StepDiagnostics), under the same placements. Every rank all-gathers its
    split pieces; the process's first rank runs the single-device advance
    on the whole state, once per process (a LocalGroup's other rank-threads
    wait for their turn meanwhile and drop their gathered copy); the result
    is split again. The compute is replicated, not partitioned (the module
    docstring)."""
    if len(placed) != len(group.ranks):
        raise ValueError(f"{len(placed)} pieces for the "
                         f"{len(group.ranks)} ranks the process drives")
    places = dict(_fields(placements))
    out = {}

    def gather(rank):
        i = group.ranks.index(rank)
        whole = _build({p: (v if places[p].kind == "replicate"
                            else rank.all_gather(v, 0))
                        for p, v in _fields(placed[i])})
        if i == 0:
            out["result"] = step_mod.advance(whole, dt, cfg)

    group.run(gather)
    state, diag = out["result"]
    return _split(state, placements, group), diag


def unplace(placed: list, placements: SimState) -> SimState:
    """The whole SimState from the pieces of every rank (a process that
    drives all of the group's ranks, as a LocalGroup's does): the split
    arrays concatenated in rank order, a replicated one taken from rank
    0."""
    places = dict(_fields(placements))
    pieces = [dict(_fields(p)) for p in placed]
    return _build({p: (pieces[0][p] if places[p].kind == "replicate"
                       else torch.cat([q[p] for q in pieces]))
                   for p in places})

