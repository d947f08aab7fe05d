"""K15's wrapper, the liquid SDF over the slot table, on the CPU: for CPU
tensors liquid_sdf_from_table is the plain composition (table_fields, then
liquid_sdf_from_particles) and counts no launch; it refuses what the kernel
does not take; the identities the kernel rests on hold against the plain
version; the pallas step sweeps its table once a substep. The kernel itself
is held against the plain version on the card (tests/test_torch_gpu.py)."""

import itertools
import math
import random

import numpy as np
import pytest
import torch

from flipviscosity3d_torch import _build, smoke
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.ops import pallas_particles as pp
from flipviscosity3d_torch.ops.buckets import cell_coords
from flipviscosity3d_torch.ops.particle_grid import liquid_sdf_from_particles
from flipviscosity3d_torch.ops.stream_transfers import (
    extrapolate_sdf_into_solid,
)
from flipviscosity3d_torch.scripts.bench import bench_scene

OFFSETS = list(itertools.product((-1, 0, 1), repeat=3))
# the orders in which the emulated kernel folds the 27 offsets
ORDERS = {"plain": OFFSETS, "reversed": OFFSETS[::-1],
          "shuffled": random.Random(15).sample(OFFSETS, len(OFFSETS))}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(name, seed=21):
    """smoke.SDF_CASES[name]'s table with a solid phi of normal values in
    cells -> (table, cap, shape, dx, radius, solid_center_phi)."""
    shape, cap, fill = smoke.SDF_CASES[name]
    gen = torch.Generator().manual_seed(seed)
    table = smoke.sdf_table(shape, cap, fill, gen, "cpu")
    dx = 1.0 / max(shape)
    solid = torch.randn(shape, generator=gen) * dx
    return (table, cap, shape, dx, SimConfig.particle_radius_factor * dx,
            solid)


def _plain(table, cap, shape, dx, radius, solid, finalize):
    return liquid_sdf_from_particles(pp.table_fields(table, cap), shape, dx,
                                     radius, solid, finalize)


@pytest.mark.parametrize("finalize", [True, False])
@pytest.mark.parametrize("name", list(smoke.SDF_CASES))
def test_wrapper_on_cpu_is_the_plain_composition(name, finalize):
    args = _inputs(name)
    table, cap, shape, dx = args[:4]
    _build.reset_launch_counts()
    got = pp.liquid_sdf_from_table(*args, finalize=finalize)
    assert torch.equal(got, _plain(*args, finalize))
    assert pp.liquid_sdf_from_table.launches == 0
    far = float(np.float32(3.0 * dx))
    if smoke.SDF_CASES[name][2] == "empty":
        want = torch.full(shape, far)
        if finalize:
            want = extrapolate_sdf_into_solid(want, args[5], dx)
        assert torch.equal(got, want)
    else:
        # particles within the radius of a centre; with "mixed", cells with
        # no particle around them
        assert bool((got < 0).any())
        assert bool((got == far).any()) == (name != "full")


REFUSALS = ["f64 table", "f64 solid", "non-contiguous table",
            "non-contiguous solid", "table of another grid",
            "table of another cap", "solid of another shape",
            "solid on another device", "cap 0"]


@pytest.mark.parametrize("case", REFUSALS)
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    table, cap, shape, dx, radius, solid = _inputs("odd")
    if case == "f64 table":
        table = table.double()
    elif case == "f64 solid":
        solid = solid.double()
    elif case == "non-contiguous table":
        table = table.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "non-contiguous solid":
        solid = solid.transpose(0, 2).contiguous().transpose(0, 2)
    elif case == "table of another grid":
        table = table[:-1].contiguous()
    elif case == "table of another cap":
        cap -= 1
    elif case == "solid of another shape":
        solid = solid[:, :-1].contiguous()
    elif case == "solid on another device":
        solid = solid.to("meta")
    else:
        table, cap = table[..., :0, :].contiguous(), 0
    with pytest.raises(ValueError):
        pp.liquid_sdf_from_table(table, cap, shape, dx, radius, solid)


def _kernel_emulated(table, cap, shape, dx, radius, solid, finalize, order):
    """K15's form of the sweep in plain torch: only each cell's slots up to
    its first empty one, each particle's 27 d^2 to the centres of the cells
    around its own, rounded as the kernel rounds them (t = u + o * dx per
    axis, u = (s + 0.5) * dx - p, d^2 = (tx tx + ty ty) + tz tz), folded
    into each target cell by a min over particles and offsets in `order`;
    then one root, the radius, the min with 3dx and the solid test."""
    n_cells = math.prod(shape)
    slots = table.reshape(n_cells, cap, 4)
    prefix = (slots[..., 3] > 0.5).to(torch.int32).cumprod(dim=1).bool()
    cell, slot = prefix.nonzero(as_tuple=True)
    p = slots[cell, slot, :3]
    at = cell_coords(shape)[:, cell].t()
    u = (at.to(torch.float32) + 0.5) * dx - p
    dims = torch.tensor(shape)
    d2min = torch.full((n_cells,), float("inf"))
    for o in order:
        t = u + torch.tensor(o, dtype=torch.float32) * np.float32(dx)
        d2 = (t[:, 0] * t[:, 0] + t[:, 1] * t[:, 1]) + t[:, 2] * t[:, 2]
        target = at + torch.tensor(o)
        inside = ((target >= 0) & (target < dims)).all(dim=1)
        flat = (target[:, 0] * shape[1] + target[:, 1]) * shape[2] + (
            target[:, 2])
        d2min.scatter_reduce_(0, flat[inside], d2[inside], "amin")
    phi = torch.minimum(torch.full((n_cells,), float(np.float32(3.0 * dx))),
                        torch.sqrt(d2min) - radius).reshape(shape)
    return extrapolate_sdf_into_solid(phi, solid, dx) if finalize else phi


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("name", list(smoke.SDF_CASES))
def test_kernel_identities_hold(name, order):
    """Skipping the empty slots, folding the offsets' d^2 in any order and
    taking the root once, after the min, change no bit of the plain
    version's result, with finalize and without; and slots after a cell's
    first empty one would have to be read if they were occupied (the
    precondition the kernel takes from K1 and K5)."""
    args = _inputs(name)
    for finalize in (True, False):
        assert torch.equal(
            _kernel_emulated(*args, finalize, ORDERS[order]),
            _plain(*args, finalize)), finalize
    table, cap = args[:2]
    if smoke.SDF_CASES[name][2] == "mixed":
        holed = table.clone()
        occupied = holed[..., 0, 3] > 0.5
        holed[..., 0, :] = 0.0   # every occupied cell now starts empty
        assert bool(occupied.any())
        assert not torch.equal(
            _kernel_emulated(holed, *args[1:], True, ORDERS[order]),
            _plain(holed, *args[1:], True))


def test_scatter_tables_fill_a_prefix_of_each_cell():
    """The tables K1's and K5's plain versions write for the 32^3 bench
    pool (torch.equal to the kernels' on the card) hold each cell's
    particles in its first slots, with cells of more than cap particles
    full, so K15 may stop at a cell's first empty slot."""
    sim = bench_scene("cpu", 32)
    cfg, state = sim.cfg, sim.state
    shape, cap = cfg.grid_shape, cfg.sdf_cap
    gen = torch.Generator().manual_seed(3)
    vel = torch.randn(state.pos.shape, generator=gen)
    stream = pp.tiled_sort(state.pos, vel, cfg.dx, shape)
    _, t1 = pp.scatter_p2g_table(stream.pos, stream.vel, stream.key,
                                 stream.rank, shape, cfg.dx, cap)
    moved = state.pos + 0.5 * cfg.dx * torch.randn(state.pos.shape,
                                                   generator=gen)
    key = pp.key_of_position(moved, cfg.dx, shape)
    plan = pp.plan_pass_a(key, shape, cfg.pallas_passa_budget,
                          cfg.pallas_passa_factor)
    _, t5, counts = pp.scatter_p2g_table_stale(moved, vel, key, plan, shape,
                                               cfg.dx, cap)
    for table in (t1, t5):
        occ = table[..., 3] > 0.5
        assert torch.equal(occ.to(torch.int32).cumprod(dim=-1).bool(), occ)
        assert int(occ.sum()) > 0
    assert torch.equal(t5[..., 3].sum(dim=-1), counts.clamp(max=cap).float())


def test_pallas_step_sweeps_the_table_once_a_substep(monkeypatch):
    """_step_pallas computes its liquid phi by liquid_sdf_from_table, once
    a substep, on the table pass A wrote; the bench run at 16^3 on the CPU,
    one warm and one timed frame."""
    calls = []
    sweep = pp.liquid_sdf_from_table

    def counted(table, cap, grid_shape, *rest, **kw):
        calls.append((tuple(table.shape), cap, tuple(grid_shape)))
        return sweep(table, cap, grid_shape, *rest, **kw)

    monkeypatch.setattr(pp, "liquid_sdf_from_table", counted)
    result = smoke.run_main_path("cpu", 16, 1, log=lambda line: None)
    assert result["failures"] == []
    substeps = sum(f["substeps"] for f in result["frames"])
    assert substeps >= 2
    assert calls == [((16, 16, 16, 16, 4), 16, (16, 16, 16))] * substeps


def test_liquid_sdf_record_runs_on_cpu():
    """smoke's K15 record (chip_smoke.py's, at 128^3 and 256^3 on the card)
    on the 16^3 bench pool's K1 table: both checks ok, the bound (of each
    cell's slots up to its first empty one) positive and below the whole
    table's."""
    sim = bench_scene("cpu", 16)
    cfg = sim.cfg
    stream = pp.tiled_sort(sim.state.pos, sim.state.vel, cfg.dx,
                           cfg.grid_shape)
    _, table = pp.scatter_p2g_table(stream.pos, stream.vel, stream.key,
                                    stream.rank, cfg.grid_shape, cfg.dx,
                                    cfg.sdf_cap)
    checks, times, bnd = smoke._liquid_sdf_record(table, cfg,
                                                  sim.state.solid.center_phi)
    assert len(checks) == 2 and all(c["ok"] for c in checks)
    assert bnd["bound_by"] == "bytes" and bnd["bound_ms"] > 0
    assert 0 < bnd["bound_ms"] < times["table_bound_ms"]
    assert times["ms"] > 0 and times["plain_ms"] > 0
