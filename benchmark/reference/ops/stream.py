"""The sorted-stream particle engine's core: segment reductions over the
cell-sorted particles, and row gathers keyed by per-particle cells.

Counterpart of flipviscosity3d_tpu/ops/stream.py. One stable sort by
i-major home cell per substep; per-cell sums of per-particle quantities
add each cell's run of the sorted stream in stream order
(`torch.segment_reduce` over the run starts), per-cell mins are a scatter
reduction over the sorted keys (`scatter_reduce_("amin")`, which no order
changes), and per-particle samples gather rows of stacked per-cell columns.
Every particle takes part in every transfer: the stream engine has no
capacity and no overflow.

Each cell's sum is added in one fixed order, first particle of the run to
last, on the card as on the CPU, so two runs from one state give the same
bits. That is also the order in which XLA's CPU scatter of the JAX
package adds them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .buckets import cell_of_position


class ParticleStream(NamedTuple):
    """Cell-sorted particle tensors plus the cell-run index.

    key: (N,) int64 sorted flat home cell of each particle (n_cells marks a
        dead or padding particle).
    sorted: (N,) float32 payload tensors in sorted order.
    new_run: (N,) bool, True at the first particle of each run of keys.
    starts: (n_cells+1,) int64 first sorted index of each cell's run
        (searchsorted-left; empty cells take the next run's start).
    counts: (n_cells,) int64 particles per cell.
    """

    key: torch.Tensor
    sorted: tuple
    new_run: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor


def cell_runs(key_s, n_cells: int):
    """Run index of a sorted key array -> (new_run, starts, counts): one
    scatter-min of the run starts, then a reverse cummin fills the empty
    cells. Keys equal to n_cells (dead particles) set starts[n_cells], as
    the JAX scatter does."""
    n = key_s.shape[0]
    dev = key_s.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    new_run = torch.ones(n, dtype=torch.bool, device=dev)
    new_run[1:] = key_s[1:] != key_s[:-1]
    starts = torch.full((n_cells + 1,), n, dtype=torch.int64, device=dev)
    starts.scatter_reduce_(0, key_s[new_run], idx[new_run], "amin")
    starts = torch.flip(torch.cummin(torch.flip(starts, (0,)), dim=0).values,
                        (0,))
    counts = starts[1:] - starts[:-1]
    return new_run, starts, counts


def stream_sort(key_pos, payload: Sequence[torch.Tensor], dx: float,
                grid_shape) -> ParticleStream:
    """Sort particles by home cell and index the runs."""
    key = cell_of_position(key_pos, dx, grid_shape)
    return stream_sort_keys(key, payload, grid_shape)


def stream_sort_keys(key, payload: Sequence[torch.Tensor],
                     grid_shape) -> ParticleStream:
    """stream_sort from flat cell keys (stable). A key may equal n_cells to
    mark a dead or padding particle: it sorts to the end, belongs to no
    cell, and never reaches a segment reduction."""
    n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]
    key_s, order = torch.sort(key.to(torch.int64), stable=True)
    new_run, starts, counts = cell_runs(key_s, n_cells)
    return ParticleStream(key_s, tuple(p[order] for p in payload), new_run,
                          starts, counts)


def segment_reduce(stream: ParticleStream, sums: Sequence[torch.Tensor],
                   mins: Sequence[torch.Tensor], min_default: float):
    """Per-cell sums and mins of per-particle (N,) float32 quantities over
    the sorted stream -> (sum_cells, min_cells), lists of (n_cells,)
    tensors; empty cells reduce to 0 / min_default. One (N, S) segmented
    sum over the cells' runs, each added in stream order: the runs end at
    starts[n_cells], so the rows of dead particles (key == n_cells), which
    sort last, belong to none. One (N, M) scatter-min into a table with a
    guard row, where the dead rows land and are dropped."""
    n_cells = stream.counts.shape[0]
    key = stream.key
    dev = key.device
    sum_cells, min_cells = [], []
    if sums:
        stacked = torch.stack(list(sums), dim=-1)
        # starts[0] is 0 (keys are >= 0) and starts is non-decreasing, the
        # checks `unsafe` skips (they would read the card)
        out = torch.segment_reduce(stacked, "sum", offsets=stream.starts,
                                   axis=0, unsafe=True)
        del stacked
        sum_cells = list(out.unbind(dim=1))
    if mins:
        stacked = torch.stack(list(mins), dim=-1)
        out = torch.full((n_cells + 1, len(mins)), min_default,
                         dtype=torch.float32, device=dev)
        out.scatter_reduce_(0, key[:, None].expand_as(stacked), stacked,
                            "amin")
        del stacked
        min_cells = list(out[:n_cells].unbind(dim=1))
    return sum_cells, min_cells


def rows_at_cells(columns, keys):
    """Per-particle rows of stacked per-cell columns: ONE (N, C) row gather.
    columns: (n_cells,) tensors; keys: (N,) i-major cell indices. Returns a
    list of (N,) tensors, one per column."""
    rows = torch.stack(columns, dim=-1)[keys]
    return list(rows.unbind(dim=1))


def decode_cells(keys, grid_shape):
    """i-major flat cell index -> (i, j, k) coordinates."""
    jk = grid_shape[1] * grid_shape[2]
    i = keys // jk
    rem = keys - i * jk
    j = rem // grid_shape[2]
    k = rem - j * grid_shape[2]
    return i, j, k
