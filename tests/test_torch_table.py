"""The port's bucket-table engine ("table", the JAX package's default)
against the JAX package's, on the CPU.

Unit inputs are made with numpy from a seed and go through the JAX function
and its port. Integer outputs are held equal (keys, slots, overflow counts,
liquid cells); float tolerances are stated per test. Empty table slots
differ on purpose (the port samples them in int64, where the JAX package's
int32 cast of a far position is meaningless) and are never read back, so
the samples are compared on filled slots only. The substep tests hand both
packages one state (tests/test_torch_step.py) and compare the particles
element by element: both leave a substep in table B's sorted order.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.ops import buckets as jb
from flipviscosity3d_tpu.ops import particle_grid as jpg
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.sim import FluidSimulation
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.io.trianglemesh import box_mesh
from flipviscosity3d_torch.ops import buckets as tb
from flipviscosity3d_torch.ops import particle_grid as tpg
from test_torch_step import (  # noqa: F401  (scene is a fixture)
    DT,
    _advance_both,
    _assert_frames_match,
    _assert_substep_matches,
    _jax_substep,
    _moving,
    _port_cfg,
    scene,
)

N = 8
DX = 1.0 / N
SHAPE = (N, N, N)
FACES = ((N + 1, N, N), (N, N + 1, N), (N, N, N + 1))
RADIUS = DX * 1.01 * np.sqrt(3) / 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _particles(n=400, seed=0, lo=0.6, hi=7.4):
    """Positions in [lo, hi) cells, a third of them crowded into 8 cells so
    that a small capacity overflows; velocities normal."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo * DX, hi * DX, size=(n, 3))
    crowd = rng.integers(2, 6, size=(8, 3))
    pick = rng.integers(0, 8, size=n // 3)
    pos[: n // 3] = (crowd[pick] + rng.uniform(0.1, 0.9, (n // 3, 3))) * DX
    vel = rng.normal(size=(n, 3))
    return pos.astype(np.float32), vel.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("capacity", "n_table_fields"))
def _jax_build(pos, vel, capacity, n_table_fields=None):
    return jb.build_buckets(
        pos, (pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1],
              vel[:, 2]), DX, SHAPE, capacity, n_table_fields=n_table_fields)


def _tables(cap, n_table_fields=None, seed=0):
    pos, vel = _particles(seed=seed)
    jt = _jax_build(jnp.asarray(pos), jnp.asarray(vel), cap, n_table_fields)
    tp, tv = torch.from_numpy(pos), torch.from_numpy(vel)
    tt = tb.build_buckets(tp, (*tp.unbind(1), *tv.unbind(1)), DX, SHAPE, cap,
                          n_table_fields=n_table_fields)
    return jt, tt


def _filled(tt):
    """Mask of the filled slots of a port table (empty ones hold 1e8)."""
    return tt.fields[0] < 1e7


def _check_build_buckets(cap, n_table_fields):
    """Every field of the BucketTable equal to JAX's: the tables (empty
    slots 1e8 in positions, 0 elsewhere), the sorted payload, slots, cells
    and the overflow count; at a capacity of 2 with 3 table fields most of
    the crowded cells' particles overflow."""
    jt, tt = _tables(cap, n_table_fields)
    assert len(tt.fields) == len(jt.fields) == (n_table_fields or 6)
    for j, t in zip(jt.fields, tt.fields):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for j, t in zip(jt.sorted, tt.sorted):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tt.slot.numpy(), np.asarray(jt.slot))
    np.testing.assert_array_equal(tt.cell.numpy(), np.asarray(jt.cell))
    assert tt.slot.dtype == torch.int64
    assert int(tt.n_overflow) == int(jt.n_overflow)
    if cap == 2:
        assert int(tt.n_overflow) > 0


def _check_gather_results(fallbacks):
    """Per-slot results mapped back to the sorted particles, overflowing
    particles taking 0 or their fallback: equal to JAX's."""
    jt, tt = _tables(2)
    rng = np.random.default_rng(1)
    results = [rng.normal(size=(2, N ** 3)).astype(np.float32)
               for _ in range(3)]
    backs = [rng.normal(size=tt.slot.shape).astype(np.float32)
             for _ in range(3)] if fallbacks else None
    want = jb.gather_results(
        jt, [jnp.asarray(r) for r in results],
        None if backs is None else [jnp.asarray(b) for b in backs])
    got = tb.gather_results(
        tt, [torch.from_numpy(r) for r in results],
        None if backs is None else [torch.from_numpy(b) for b in backs])
    for j, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _solid_center():
    rng = np.random.default_rng(2)
    return rng.uniform(-0.2, 1.0, SHAPE).astype(np.float32)


def _check_p2g_and_sdf():
    """The fused pass-A sweep: phi to 1e-6 with the same cells below zero
    (and the solid extrapolation at the same cells); the three components'
    value and weight sums to rtol 1e-5 / atol 1e-6 (the cap axis is summed
    in another order)."""
    jt, tt = _tables(16)
    solid = _solid_center()
    jphi, jsums = jax.jit(jpg.p2g_and_sdf, static_argnames=(
        "grid_shape", "face_shapes"))(jt, SHAPE, DX, RADIUS,
                                      jnp.asarray(solid), FACES)
    tphi, tsums = tpg.p2g_and_sdf(tt, SHAPE, DX, RADIUS,
                                  torch.from_numpy(solid), FACES)
    jphi = np.asarray(jphi)
    np.testing.assert_allclose(tphi.numpy(), jphi, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tphi.numpy() < 0, jphi < 0)
    assert (jphi == np.float32(-0.5 * DX)).any()
    for (jv, jw), (tv, tw) in zip(jsums, tsums):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)


def _check_liquid_sdf(finalize):
    """The SDF sweep on a BucketTable, with and without the solid
    extrapolation: to 1e-6 (the min of d^2 before the root, as JAX)."""
    jt, tt = _tables(16)
    solid = _solid_center()
    want = jax.jit(jpg.liquid_sdf_from_particles, static_argnames=(
        "grid_shape", "finalize"))(jt, SHAPE, DX, RADIUS, jnp.asarray(solid),
                                   finalize=finalize)
    got = tpg.liquid_sdf_from_particles(tt, SHAPE, DX, RADIUS,
                                        torch.from_numpy(solid),
                                        finalize=finalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _check_p2g_component():
    """One component at a time (u, v, w of the velocity fields) to rtol
    1e-5 / atol 1e-6."""
    jt, tt = _tables(16)
    for ci, comp in enumerate("uvw"):
        jv, jw = jax.jit(jpg.p2g_component, static_argnames=(
            "grid_shape", "component", "face_shape"))(
            jt, jt.fields[3 + ci], SHAPE, DX, comp, FACES[ci])
        tv, tw = tpg.p2g_component(tt, tt.fields[3 + ci], SHAPE, DX, comp,
                                   FACES[ci])
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)


def _check_sample_mac_at_table():
    """The MAC velocity at every filled slot, with and without an in-domain
    mask that drops a fifth of them: to 1e-6 of max|u| (the same products
    and sums in the same order; XLA may contract them)."""
    jt, tt = _tables(16)
    rng = np.random.default_rng(3)
    grids = [rng.normal(size=f).astype(np.float32) for f in FACES]
    mask = rng.uniform(size=(16, N ** 3)) > 0.2
    filled = _filled(tt).numpy()
    for in_domain in (None, mask):
        want = jpg.sample_mac_at_table(
            jt, *(jnp.asarray(g) for g in grids), DX,
            None if in_domain is None else jnp.asarray(in_domain))
        got = tpg.sample_mac_at_table(
            tt, *(torch.from_numpy(g) for g in grids), DX,
            None if in_domain is None else torch.from_numpy(in_domain))
        for j, t in zip(want, got):
            np.testing.assert_allclose(t.numpy()[filled],
                                       np.asarray(j)[filled], rtol=0,
                                       atol=1e-6 * 5)
            if in_domain is not None:
                assert not t.numpy()[filled & ~in_domain].any()


def _check_solid_pushback_displacement():
    """The per-slot pushback out of a solid whose node SDF crosses zero
    inside the particles' cells: to 1e-7 on filled slots, and some
    particles move."""
    jt, tt = _tables(16)
    ii, jj, kk = np.meshgrid(*(np.arange(N + 1),) * 3, indexing="ij")
    phi = ((jj - 3.3) * DX + 0.01 * np.sin(ii + kk)).astype(np.float32)
    want = jpg.solid_pushback_displacement(jt, jnp.asarray(phi), DX, SHAPE)
    got = tpg.solid_pushback_displacement(tt, torch.from_numpy(phi), DX,
                                          SHAPE)
    filled = _filled(tt).numpy()
    for j, t in zip(want, got):
        np.testing.assert_allclose(t.numpy()[filled], np.asarray(j)[filled],
                                   rtol=0, atol=1e-7)
    assert np.abs(got[1].numpy()[filled]).max() > 0.01 * DX


def test_build_buckets_and_gather_results_match_jax():
    """build_buckets at a capacity of 16 with all six fields and at 2 with
    3 table fields; gather_results without and with fallbacks."""
    _check_build_buckets(16, None)
    _check_build_buckets(2, 3)
    _check_gather_results(False)
    _check_gather_results(True)


def test_table_transfers_match_jax():
    """p2g_and_sdf, liquid_sdf_from_particles (finalize False and True),
    p2g_component, sample_mac_at_table and solid_pushback_displacement."""
    _check_p2g_and_sdf()
    _check_liquid_sdf(False)
    _check_liquid_sdf(True)
    _check_p2g_component()
    _check_sample_mac_at_table()
    _check_solid_pushback_displacement()


JAX_TABLE = JaxConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                      bucket_capacity=16, particle_engine="table")


def test_table_substep_and_three_frames_match_jax(scene):
    """At a capacity of 16 and of 2 (one JAX compile each): one substep
    from a moving state element by element (_assert_substep_matches, positions to 1e-6), then three frames of
    advance from rest (_assert_frames_match: substeps, iterations and
    overflow equal, rtol 2e-3 / atol 2e-4), liquid cells equal frame by
    frame. At a capacity of 2 both tables overflow: the overflow count and
    the fallbacks (own velocity and midpoint in pass A, own velocity in
    pass B) must agree for the particles to."""
    for cap in (16, 2):
        _check_table_run(scene, cap)


def _check_table_run(scene, cap):
    base, arrays = scene
    jcfg = dataclasses.replace(JAX_TABLE, bucket_capacity=cap)
    cfg = _port_cfg(base, jcfg)
    assert (cfg.particle_engine, cfg.bucket_capacity) == ("table", cap)
    moving = _moving(arrays)
    jnew, jd = _jax_substep(moving, 0.01, jcfg)
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), DT, cfg)
    assert (int(td["bucket_overflow"]) > 0) == (cap == 2)
    _assert_substep_matches(tnew, td, jnew, jd)
    ts, tds, js, jds = _advance_both(arrays, cfg, jcfg, 0.01, 3)
    _assert_frames_match(ts, tds, js, jds)
    assert [td.liquid_cells for td in tds] == [int(jd.liquid_cells)
                                               for jd in jds]
    assert all((td.bucket_overflow > 0) == (cap == 2) for td in tds)
    assert all(td.plan_demand == 0 and td.uncovered_pass_a == 0
               and td.stale_substeps == 0 for td in tds)


def test_engines_without_tiles_run_a_grid_of_12():
    """Only the "pallas" engine needs whole 8x8x8 tiles: on a 12^3 grid the
    table and stream engines run a substep in both packages, with the same
    results (_assert_substep_matches), and the pallas engine refuses the
    grid."""
    for engine in ("table", "stream"):
        _check_grid_of_12(engine)


def _check_grid_of_12(engine):
    sim = FluidSimulation("cpu")
    sim.initialize(12, 12, 12, 1.0 / 12, bucket_capacity=16,
                   particle_engine=engine)
    sim.add_liquid(box_mesh((0.2, 0.2, 0.2), (0.8, 0.55, 0.8)))
    sim.set_viscosity(2.0)
    moving = _moving(state_to_numpy(sim.state))
    jcfg = JaxConfig(isize=12, jsize=12, ksize=12, dx=1.0 / 12,
                     bucket_capacity=16, particle_engine=engine)
    jnew, jd = _jax_substep(moving, 0.01, jcfg)
    tnew, td = tstep.step(state_from_numpy(moving, "cpu"), DT, sim.cfg)
    _assert_substep_matches(tnew, td, jnew, jd)
    with pytest.raises(ValueError):
        tstep.step(state_from_numpy(moving, "cpu"), DT,
                   dataclasses.replace(sim.cfg, particle_engine="pallas"))
