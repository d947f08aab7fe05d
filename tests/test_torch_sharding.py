"""The port's placement helpers (parallel/sharding.py: grid_sharding,
state_shardings, shard_state, advance_placed) and its dry run
(graft_entry.py) against the JAX package on the CPU.

The placement table must equal JAX's PartitionSpecs array by array; the
placed pieces must equal the data of jax.device_put's shards on the 8
forced host devices (tests/conftest.py), in device order; the port raises
ValueError where device_put does. advance_placed is held to
tests/test_sharding.py's bar against JAX's single-device advance (equal
substeps and pressure iterations, sorted positions within 5e-6, u and v
within 1e-5) and must equal the port's own single-device advance bit for
bit. JAX's pjit step itself is not run here: it is the one whose XLA
rendezvous aborts some runs (ROADMAP watch-list). States are handed to
both packages as numpy arrays (core.state.state_from_numpy), since the
packages seed particles differently.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.core import step as jstep
from flipviscosity3d_tpu.parallel import sharding as jsharding
from flipviscosity3d_torch import graft_entry, smoke
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.sim import FluidSimulation
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.io.trianglemesh import box_mesh
from flipviscosity3d_torch.parallel import sharding as tsharding
from flipviscosity3d_torch.parallel.collectives import LocalGroup
from test_torch_step import _jax_state

N = 16
NDEV = 8
DT = 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    """tests/test_sharding.py's scene (16^3, a box of liquid, viscosity
    1.0), its particles trimmed to a multiple of 8, as numpy."""
    torch.set_num_threads(1)
    sim = FluidSimulation("cpu")
    sim.initialize(N, N, N, 1.0 / N)
    sim.add_liquid(box_mesh((0.2, 0.25, 0.2), (0.8, 0.6, 0.8)))
    sim.set_viscosity(1.0)
    arrays = state_to_numpy(sim.state)
    n = arrays["pos"].shape[0] // NDEV * NDEV
    return sim.cfg, dict(arrays, pos=arrays["pos"][:n], vel=arrays["vel"][:n])


def _jax_cfg(cfg):
    return JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})


def _leaves(tree):
    """(name, leaf) of a SimState-shaped tree of either package, the solid
    fields as solid.<name>, in the port's field order."""
    from flipviscosity3d_torch.core.state import _SOLID_FIELDS, _STATE_FIELDS

    out = [(k, getattr(tree, k)) for k in _STATE_FIELDS]
    return out + [(f"solid.{k}", getattr(tree.solid, k))
                  for k in _SOLID_FIELDS]


def _spec(p: tsharding.Placement) -> tuple:
    """A Placement as the PartitionSpec tuple it stands for."""
    if p.kind == "replicate":
        return ()
    return ("x",) + (None,) * (p.ndim - 1)


@pytest.mark.parametrize("isize, n", [(16, 8), (15, 8), (16, 4), (17, 8)])
def test_placement_table_equals_jax_specs(isize, n):
    """state_shardings spec by spec against JAX's: grids split on i where n
    divides their first extent (the cell grids at I = 16, the I+1-row
    ones at I = 15), particles split, gravity replicated."""
    cfg = SimConfig(isize=isize, jsize=16, ksize=16, dx=1.0 / 16)
    want = jsharding.state_shardings(jsharding.make_mesh(n), _jax_cfg(cfg))
    got = tsharding.state_shardings(LocalGroup(n, "cpu"), cfg)
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == 15
    for (name, g), (_, w) in pairs:
        assert _spec(g) == tuple(w.spec), name
    kinds = {name: g.kind for name, g in _leaves(got)}
    split_cells = isize % n == 0
    assert kinds["solid.center_phi"] == ("shard_i" if split_cells
                                         else "replicate")
    assert kinds["u"] == ("shard_i" if (isize + 1) % n == 0
                          else "replicate")
    assert kinds["pos"] == "shard_i" and kinds["gravity"] == "replicate"


def test_shard_state_pieces_equal_jax_shards(scene):
    """Every rank's piece of every array torch.equal to the data of the
    shard jax.device_put puts on device r, at 16^3 on 8 ranks."""
    cfg, arrays = scene
    group = LocalGroup(NDEV, "cpu")
    placed, _ = tsharding.shard_state(state_from_numpy(arrays, "cpu"),
                                      group, cfg)
    mesh = jsharding.make_mesh(NDEV)
    sharded, _ = jsharding.shard_state(_jax_state(arrays), mesh,
                                       _jax_cfg(cfg))
    devices = list(mesh.devices)
    split = 0
    for (name, arr), *pieces in zip(_leaves(sharded),
                                    *(_leaves(p) for p in placed)):
        by_device = {s.device: np.asarray(s.data)
                     for s in arr.addressable_shards}
        assert len(by_device) == NDEV, name
        for r, (_, piece) in enumerate(pieces):
            want = torch.from_numpy(np.array(by_device[devices[r]]))
            assert torch.equal(piece, want), (name, r)
        split += pieces[0][1].shape != arr.shape
    assert split == 9   # pos, vel and the 7 cell-extent grids


@pytest.mark.parametrize("case", ["particles", "grid"])
def test_shard_state_raises_where_device_put_raises(scene, case):
    """A particle count 8 does not divide, and a 15^3 state placed under a
    16^3 config (its 15-row grids under a split placement): device_put
    raises ValueError, and so does shard_state; neither pads."""
    cfg, arrays = scene
    if case == "particles":
        arrays = dict(arrays, pos=arrays["pos"][:-3], vel=arrays["vel"][:-3])
    else:
        sim = FluidSimulation("cpu")
        sim.initialize(15, 15, 15, 1.0 / 15)
        sim.add_liquid(box_mesh((0.2, 0.25, 0.2), (0.8, 0.6, 0.8)))
        small = state_to_numpy(sim.state)
        n = small["pos"].shape[0] // NDEV * NDEV
        arrays = dict(small, pos=small["pos"][:n], vel=small["vel"][:n])
    with pytest.raises(ValueError):
        jax.device_put(_jax_state(arrays), jsharding.state_shardings(
            jsharding.make_mesh(NDEV), _jax_cfg(cfg)))
    with pytest.raises(ValueError):
        tsharding.shard_state(state_from_numpy(arrays, "cpu"),
                              LocalGroup(NDEV, "cpu"), cfg)


def test_advance_placed_matches_single_device(scene):
    """advance_placed on 8 CPU rank-threads: JAX's single-device advance
    within tests/test_sharding.py:50-66's bar, and the port's own
    single-device advance bit for bit (diagnostics equal); the step ran
    once, with one all-gather per split array."""
    cfg, arrays = scene
    group = LocalGroup(NDEV, "cpu", timeout=120)
    placed, placements = tsharding.shard_state(
        state_from_numpy(arrays, "cpu"), group, cfg)
    placed, diag = tsharding.advance_placed(placed, placements, DT, cfg,
                                            group)
    got = tsharding.unplace(placed, placements)
    own, own_diag = tstep.advance(state_from_numpy(arrays, "cpu"), DT, cfg)
    assert smoke.state_diffs(got, own) == [] and diag == own_diag
    assert group.counts()["all_gather"]["calls"] == 9

    want, jdiag = jstep.advance(_jax_state(arrays), DT, _jax_cfg(cfg))
    assert diag.substeps == int(jdiag.substeps)
    assert diag.pressure_iterations == int(jdiag.pressure_iterations)
    np.testing.assert_allclose(np.sort(got.pos.numpy(), axis=0),
                               np.sort(np.asarray(want.pos), axis=0),
                               atol=5e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5)


def test_placed_path_and_stream_repeat_run_small():
    """smoke's placed and stream_repeat phases at 16^3 on the CPU (the plain
    versions): the placed frames equal the single-device ones; the two
    stream runs, and the two slab runs on 2 ranks, are equal."""
    placed = smoke.run_placed_path("cpu", 16, n_ranks=NDEV,
                                   log=lambda _: None)
    assert placed["failures"] == [] and len(placed["frames"]) == 2
    assert all(f["equal_to_single_device"] for f in placed["frames"])
    repeat = smoke.run_stream_repeat("cpu", 16, frames=1, n_slabs=2,
                                     log=lambda _: None)
    assert repeat["failures"] == []
    assert len(set(map(tuple, repeat["liquid_cells"]))) == 1


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_migrates_and_loses_nothing(n, capsys):
    """graft_entry.dryrun_multichip on n CPU rank-threads: the slab half's
    +x drift migrates particles across slab faces and loses none; both
    halves print JAX's OK lines."""
    out = graft_entry.dryrun_multichip(n, "cpu")
    assert out["slab"]["migrated"] > 0
    assert sum(out["slab"]["occupancy"]) == 4096
    assert out["placed"]["substeps"] >= 1
    printed = capsys.readouterr().out
    assert f"dryrun_multichip slab OK: {n} devices" in printed
    assert f"dryrun_multichip pjit OK: {n} devices" in printed


def test_entry_runs_one_frame():
    """entry()'s fn on the CPU: positions of the 4096 particles, u of
    (17, 16, 16), at least one substep."""
    fn, (state, dt) = graft_entry.entry("cpu")
    pos, u, substeps = fn(state, dt)
    assert pos.shape == (4096, 3) and bool(torch.isfinite(pos).all())
    assert tuple(u.shape) == (17, 16, 16) and substeps >= 1
