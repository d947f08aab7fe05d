"""The collectives of the slab pipeline: the port's counterpart of what
jax.shard_map gives every slab-local function of the JAX package
(lax.axis_index, ppermute, psum, pmax, all_gather).

A SlabGroup is one rank's handle. Its operations are collective: every rank
of the group calls them in the same order with tensors of the same shapes.

- `ppermute(x, pairs)`: rank d receives x of rank s for each (s, d) in
  pairs; a rank that receives nothing gets zeros (as lax.ppermute).
  `ppermute_many` runs several in one round.
- `psum(x)`, `pmax(x)`: the sum / max over the ranks, added in rank order
  on every rank from the same inputs, so that every rank holds the same
  bits (loop predicates that read them take the same branch everywhere).
- `all_gather(x, axis)`: the ranks' tensors concatenated along `axis` in
  rank order (lax.all_gather(..., tiled=True)).

Each handle tallies its calls and the bytes it sent, by kind (`tally`);
a group's `counts()` sums them up. A handle whose `trace` is a list also
appends (kind, shape, bytes sent, calling function) per call (the audit of
scripts/shard_collectives.py).

Two kinds of group:

- `LocalGroup(n, device)`: n ranks as n Python threads of one process on one
  device, taking turns (LocalGroup's docstring). Each rank posts a private
  copy of what it sends into a shared slot and hands the turn on; the slots
  are double-buffered, so one pass of the turn per collective suffices. On
  a CUDA device every thread launches on the device's default stream,
  whose order makes a copy posted before the turn passed visible to a read
  enqueued after it. This is how one card, or the CPU in the tests, runs
  several slabs (the JAX tests force 8 host devices for the same purpose).
  Each wait for a turn has a timeout, and a rank that raises breaks the
  turn for all the others: a fault surfaces on the calling thread as the
  rank's own exception, never as a hang.
- `DistGroup()`: one rank per process over torch.distributed (NCCL for CUDA
  tensors, gloo for CPU ones); neighbour exchange through
  batch_isend_irecv, psum / pmax through an all_gather and the same rank-
  order reduction as LocalGroup's, so that both groups give the same bits.

A group's `run(fn)` calls fn(rank handle) for each rank the process drives
and returns the results in rank order.
"""

from __future__ import annotations

import sys
import threading
import time

import torch

KINDS = ("ppermute", "psum", "pmax", "all_gather")
DEFAULT_TIMEOUT_S = 600.0


def ring(n: int, shift: int):
    """Non-wrapping neighbour pairs (s, s + shift) of n ranks."""
    return [(s, s + shift) for s in range(n) if 0 <= s + shift < n]


class SlabGroup:
    """One rank's handle on its group's collectives."""

    rank: int
    size: int
    device: torch.device
    trace: list | None = None

    def _init_counts(self) -> None:
        self.tally = {k: [0, 0] for k in KINDS}

    def _count(self, kind: str, nbytes: int, x) -> None:
        c = self.tally[kind]
        c[0] += 1
        c[1] += nbytes
        if self.trace is not None:
            f = sys._getframe(1)
            while f.f_code.co_filename == __file__:
                f = f.f_back
            self.trace.append((kind, tuple(x.shape), nbytes,
                               f.f_code.co_name))

    def ppermute(self, x, pairs):
        return self.ppermute_many([(x, pairs)])[0]

    def ppermute_many(self, items):
        """[(x, pairs), ...] -> the received tensors, in one round; each
        item counts as one ppermute."""
        for x, pairs in items:
            sent = sum(1 for s, _ in pairs if s == self.rank)
            self._count("ppermute", sent * x.numel() * x.element_size(), x)
        return self._permute(items)

    def psum(self, x):
        self._count("psum", x.numel() * x.element_size(), x)
        return torch.stack(self._gather_list(x)).sum(dim=0)

    def pmax(self, x):
        self._count("pmax", x.numel() * x.element_size(), x)
        return torch.stack(self._gather_list(x)).amax(dim=0)

    def all_gather(self, x, axis: int):
        self._count("all_gather", x.numel() * x.element_size(), x)
        return torch.cat(self._gather_list(x), dim=axis)


class _LocalRank(SlabGroup):
    def __init__(self, hub: "LocalGroup", rank: int):
        self._hub = hub
        self.rank = rank
        self.size = hub.size
        self.device = hub.device
        self._round = 0
        self._init_counts()

    def _post(self, value):
        """Post `value` (never written again), hand the turn on, and return
        every rank's post of this round once the turn comes back: by then
        every rank has posted."""
        hub = self._hub
        slots = hub._slots[self._round % 2]
        self._round += 1
        slots[self.rank] = value
        hub._pass_turn(self.rank)
        hub._wait_turn(self.rank)
        return list(slots)

    def _permute(self, items):
        posts = self._post([x.detach().clone() for x, _ in items])
        out = []
        for j, (x, pairs) in enumerate(items):
            src = [s for s, d in pairs if d == self.rank]
            out.append(posts[src[0]][j] if src else torch.zeros_like(x))
        return out

    def _gather_list(self, x):
        return self._post(x.detach().clone())


class LocalGroup:
    """n slab ranks as n threads of this process on `device`.

    The threads take turns: rank r runs until its next collective, posts,
    and hands the turn to rank r + 1; the last rank hands it back to rank 0,
    which then reads the round's posts, and so on. So every collective is a
    barrier (no rank reads a round before all have posted), and only one
    thread runs Python at a time: threads that all ran at once would trade
    the interpreter lock at every tensor operation, which on the card cost
    more than the operations. `timeout` seconds bound each wait for a turn.
    """

    def __init__(self, n: int, device="cpu",
                 timeout: float = DEFAULT_TIMEOUT_S):
        if n < 1:
            raise ValueError(f"a group needs at least one rank, got {n}")
        self.size = n
        self.device = torch.device(device)
        self.timeout = timeout
        self.ranks = [_LocalRank(self, r) for r in range(n)]
        self._cond = threading.Condition()
        self._new_run()

    def _new_run(self) -> None:
        self._turn = 0
        self._broken = False
        self._slots = ([None] * self.size, [None] * self.size)
        for r in self.ranks:
            r._round = 0

    def _pass_turn(self, rank: int) -> None:
        with self._cond:
            self._turn = (rank + 1) % self.size
            self._cond.notify_all()

    def _wait_turn(self, rank: int) -> None:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._broken or self._turn == rank, self.timeout)
            if not ok or self._broken:
                self._break()
                raise threading.BrokenBarrierError(
                    f"slab rank {rank}: " + ("another rank failed" if ok
                                             else f"no turn in "
                                             f"{self.timeout} s"))

    def _break(self) -> None:
        with self._cond:
            self._broken = True
            self._cond.notify_all()

    def reset_counts(self) -> None:
        for r in self.ranks:
            r._init_counts()

    def counts(self) -> dict:
        """{kind: {"calls": one rank's calls, "bytes": sent by all ranks}}."""
        return {k: {"calls": self.ranks[0].tally[k][0],
                    "bytes": sum(r.tally[k][1] for r in self.ranks)}
                for k in KINDS}

    def run(self, fn):
        """fn(rank handle) on every rank, each on its own thread -> the
        results in rank order. The first exception of a rank (not the
        broken turn it left the others) is raised here."""
        self._new_run()
        results = [None] * self.size
        errors = [None] * self.size
        dev = self.device
        # the threads launch on the caller's card when the device names none
        index = (None if dev.type != "cuda" else dev.index
                 if dev.index is not None else torch.cuda.current_device())

        def body(r):
            try:
                if index is not None:
                    torch.cuda.set_device(index)
                self._wait_turn(r)
                results[r] = fn(self.ranks[r])
                self._pass_turn(r)
            except BaseException as e:   # noqa: BLE001 (re-raised below)
                errors[r] = e
                self._break()

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"slab-rank-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        # a rank stuck outside a collective is left behind `timeout` s after
        # another rank failed (the rest give up at their turn by then)
        deadline = None
        while any(t.is_alive() for t in threads):
            for t in threads:
                t.join(0.05)
            if any(errors):
                deadline = deadline or time.monotonic() + self.timeout
                if time.monotonic() > deadline:
                    break
        if any(errors) or any(t.is_alive() for t in threads):
            first = next((e for e in errors if e is not None and not
                          isinstance(e, threading.BrokenBarrierError)),
                         next((e for e in errors if e is not None), None))
            if first is None:
                raise RuntimeError("a slab rank did not finish")
            raise first
        return results


class DistGroup(SlabGroup):
    """This process's rank of the torch.distributed default process group
    (initialised by the caller). Slab s is the process of rank s: under a
    launcher that numbers ranks host-major (rank = host * ranks_per_host +
    local rank), slabs [h * C, (h + 1) * C) lie on host h."""

    def __init__(self, device=None):
        import torch.distributed as dist

        self._dist = dist
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        if device is None:
            device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device = torch.device(device)
        self.ranks = [self]
        self._init_counts()

    def reset_counts(self) -> None:
        self._init_counts()

    def counts(self) -> dict:
        """{kind: {"calls", "bytes"}} of this process's rank."""
        return {k: {"calls": c, "bytes": b}
                for k, (c, b) in self.tally.items()}

    def _permute(self, items):
        dist = self._dist
        ops, out = [], []
        for tag, (x, pairs) in enumerate(items):
            x = x.contiguous()
            got = torch.zeros_like(x)
            for s, d in pairs:
                if s == self.rank:
                    ops.append(dist.P2POp(dist.isend, x, d, tag=tag))
                if d == self.rank:
                    ops.append(dist.P2POp(dist.irecv, got, s, tag=tag))
            out.append(got)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def _gather_list(self, x):
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(parts, x)
        return parts

    def run(self, fn):
        return [fn(self)]
