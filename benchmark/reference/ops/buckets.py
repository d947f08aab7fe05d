"""Cell-bucketed particle tables: the "table" engine's core, and the
home-cell indexing that every engine shares.

Counterpart of flipviscosity3d_tpu/ops/buckets.py. Per pass the particles
are sorted by home cell (i-major flat index) and the first
`capacity` particles of every cell are written into dense
(capacity, n_cells) tables, one per field; every particle<->grid transfer
of the table engine is then a dense reduction or sample over the tables
(ops/particle_grid.py), and `gather_results` maps per-slot results back to
the particles. A particle of in-cell rank >= capacity is left out of the
tables and takes a fallback value.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class BucketTable(NamedTuple):
    """Dense per-cell particle table.

    fields: (capacity, n_cells) float32 tensors, in the order the payload
        was passed (positions first by convention).
    sorted: the (N,) payload tensors in sorted order, the particle order
        after this pass (and the fallback data of overflowing particles).
    slot: (N,) int64 flat table slot of each sorted particle,
        rank * n_cells + cell; capacity * n_cells (past the table) for a
        particle left out by overflow.
    cell: (N,) int64 home cell of each sorted particle.
    n_overflow: () int64 number of particles that did not fit.
    """

    fields: tuple
    sorted: tuple
    slot: torch.Tensor
    cell: torch.Tensor
    n_overflow: torch.Tensor


def cell_of_position(pos, dx, grid_shape):
    """Clamped home cell of (N,3) positions -> i-major flat index
    (grid3d.h:37-43 floor semantics, clamped into the grid)."""
    idx = torch.floor(pos / dx).to(torch.int64)
    i, j, k = (idx[:, a].clamp(0, grid_shape[a] - 1) for a in range(3))
    return (i * grid_shape[1] + j) * grid_shape[2] + k


def run_ranks(key_s, dtype=torch.int64):
    """Rank of each element of a sorted key array within its run of equal
    keys (0 at a run's start), as `dtype`."""
    n = key_s.shape[0]
    idx = torch.arange(n, dtype=dtype, device=key_s.device)
    new_run = torch.ones(n, dtype=torch.bool, device=key_s.device)
    new_run[1:] = key_s[1:] != key_s[:-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    return idx - run_start


def build_buckets(key_pos, payload: Sequence[torch.Tensor], dx: float,
                  grid_shape, capacity: int, default_far: float = 1.0e8,
                  n_table_fields: int | None = None) -> BucketTable:
    """Sort particles by the cell holding `key_pos` (stable) and build the
    dense tables.

    payload: (N,) float32 tensors; by convention the first three are the
    positions the dense transfers read. Empty slots hold `default_far` in
    the first three fields (distances are huge and kernel weights vanish
    without a mask) and 0 elsewhere. Only the first `n_table_fields`
    payload entries are written into tables; the rest ride along in the
    sort (`.sorted`)."""
    n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]
    key = cell_of_position(key_pos, dx, grid_shape)
    key_s, order = torch.sort(key, stable=True)
    payload_s = tuple(p[order] for p in payload)

    rank = run_ranks(key_s)
    ok = rank < capacity
    n_overflow = (~ok).sum()
    slot = torch.where(ok, rank * n_cells + key_s,
                       torch.full_like(key_s, capacity * n_cells))

    n_fields = len(payload_s) if n_table_fields is None else n_table_fields
    fields = []
    slot_ok = slot[ok]
    for f in range(n_fields):
        default = default_far if f < 3 else 0.0
        col = torch.full((capacity * n_cells,), default, dtype=torch.float32,
                         device=key_pos.device)
        # the JAX scatter drops the out-of-range slots (mode="drop")
        col[slot_ok] = payload_s[f][ok]
        fields.append(col.reshape(capacity, n_cells))
    return BucketTable(tuple(fields), payload_s, slot, key_s, n_overflow)


def gather_results(table: BucketTable, results: Sequence[torch.Tensor],
                   fallbacks: Sequence[torch.Tensor] | None = None):
    """Map per-slot results (capacity, n_cells) back to flat (N,) tensors in
    the sorted particle order, with one row gather of the stacked results.
    Overflowing particles (whose data never entered the table) take
    `fallbacks[i]` (0 if no fallbacks are given)."""
    size = results[0].numel()
    ok = table.slot < size
    stacked = torch.stack([r.reshape(-1) for r in results], dim=-1)
    rows = stacked[table.slot.clamp(max=size - 1)]
    rows = torch.where(ok[:, None], rows, torch.zeros_like(rows))
    out = []
    for i in range(len(results)):
        g = rows[:, i]
        if fallbacks is not None:
            g = torch.where(ok, g, fallbacks[i])
        out.append(g)
    return out


def cell_coords(grid_shape, device=None):
    """(3, n_cells) int64 coordinates of every i-major flat cell index."""
    ii, jj, kk = torch.meshgrid(
        *(torch.arange(n, device=device) for n in grid_shape), indexing="ij")
    return torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)])
