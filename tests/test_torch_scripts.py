"""The port's single-device measurement modules (flipviscosity3d_torch/
scripts: profile_substep, pallas_engine_probe, mg_pallas_bench, mg_profile,
solver_microbench, precond_experiment, particle_microbench, readiness256,
readiness512) on the CPU.

Every module runs from its command line with --device cpu at a small size
in a process where jax cannot be imported. Their results are then held
against the JAX package on the same inputs. The JAX scripts change the
process when imported (a compilation cache, environment knobs read at
import), so they are not imported here: the lines a comparison needs are
written out below from the scripts as of commit db376e7, citing file:line
and the git blob (solver_microbench.py e5a17fc, particle_microbench.py
060019f, mg_pallas_bench.py b2d21e9, mg_profile.py 40ff83a,
precond_experiment.py 7c2641e): a later edit of those scripts wants them
read again. States are handed to both packages as numpy arrays
(core.state.state_from_numpy), since the packages seed particles
differently.

Tolerances: systems and P2G sums rtol 1e-5 with an atol of 1e-6 x the
largest magnitude (values that cancel to near zero differ in summation
order only); V-cycles rtol 2e-5 / atol 2e-5, as tests/test_torch_
multigrid.py; integers (keys, coverage, visits, substeps) exactly;
iteration counts within 1.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.ops import pallas_particles as tpp
from flipviscosity3d_torch.solvers import pressure as tpsolver
from flipviscosity3d_torch.solvers import viscosity as tvsolver
from flipviscosity3d_torch.scripts import (
    mg_pallas_bench,
    mg_profile,
    pallas_engine_probe,
    particle_microbench,
    precond_experiment,
    profile_substep,
    solver_microbench,
)
from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.core import step as jstep
from flipviscosity3d_tpu.ops import particle_grid as jpg
from flipviscosity3d_tpu.ops import pallas_particles as jpp
from flipviscosity3d_tpu.ops import stream_transfers as jst
from flipviscosity3d_tpu.ops.buckets import build_buckets as jbuild_buckets
from flipviscosity3d_tpu.ops.extrapolate import (
    extrapolate_velocity_field as jextrapolate,
)
from flipviscosity3d_tpu.ops.grids import (
    face_borders_fluid_u,
    face_borders_fluid_v,
    face_borders_fluid_w,
)
from flipviscosity3d_tpu.ops.stream import stream_sort as jstream_sort
from flipviscosity3d_tpu.solvers import multigrid as jmg
from flipviscosity3d_tpu.solvers import pressure as jpsolver
from flipviscosity3d_tpu.solvers import viscosity as jvsolver
from test_torch_step import _jax_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MG_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_cfg(cfg):
    return JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=1e-6 * max(float(np.abs(want).max()),
                                              1e-30))


# (module, small-size flags, names its result must hold: the JAX script's
# rows, modes or printed values)
CLI_CASES = [
    ("profile_substep", ["--res", "16"], profile_substep.ROWS),
    ("pallas_engine_probe", ["--res", "16", "--n", "3000"],
     pallas_engine_probe.ROWS + ("b_prime", "stale_pass_a")),
    ("mg_pallas_bench", ["--res", "16", "--k", "3"],
     ("(16, 16, 16) xla v_cycle x3", "(16, 16, 16) pallas v_cycle x3",
      "(3, 17, 17, 17) xla v_cycle x3", "(3, 17, 17, 17) pallas v_cycle x3",
      "checks")),
    ("mg_profile", ["--res", "16", "--k", "3"],
     ("identity mul", "7pt apply", "smooth x1", "pool_sum", "prolong",
      "restrict+prolong round trip", "v_cycle L2 dense", "b identity mul",
      "b 7pt apply", "b smooth x1", "b pool_sum", "b prolong",
      "b v_cycle L2 dense", "b v_cycle L3 dense")),
    ("solver_microbench", ["--res", "16", "--warm-frames", "1"],
     tuple(f"{s} {name}" for name, _ in solver_microbench.VARIANTS
           for s in "pv")),
    ("precond_experiment", ["--res", "16", "--frames", "1", "--modes",
                            "jacobi,multigrid,mixed", "--mg-max-levels", "3"],
     ("jacobi/jacobi", "mg/mg levels=3", "jacobi-p/mg-v")),
    ("particle_microbench", ["--res", "16", "--np", "3000", "--with-table"],
     particle_microbench.ROWS + particle_microbench.TABLE_ROWS
     + ("table_overflow",)),
    ("readiness256", ["--res", "32", "--npart", "4000"],
     ("first_substep_s", "warm_substep_s", "com_y", "overflow",
      "pressure_iterations", "viscosity_iterations")),
    ("readiness512", ["--res", "32", "--npart", "5000", "--ndev", "4"],
     ("res", "isize", "n_devices", "n_particles", "slab_shape", "substeps",
      "pressure_iters", "viscosity_iters", "first_substep_s", "peak_gb")),
]


def _names(result):
    return (set(result) | {r["stage"] for r in result.get("rows", [])}
            | {m["mode"] for m in result.get("modes", [])})


@pytest.mark.parametrize("module, flags, names", CLI_CASES,
                         ids=[c[0] for c in CLI_CASES])
def test_script_modules_run_from_the_command_line_without_jax(module, flags,
                                                              names):
    """python -m flipviscosity3d_torch.scripts.<name> --device cpu exits 0
    in a process where jax cannot be imported; its last line is its result
    as JSON, ok, with every row the JAX script prints; without --device it
    asks for the card and fails here."""
    code = ("import sys, runpy, torch; sys.modules['jax'] = None; "
            "torch.set_num_threads(1); "
            f"sys.argv = ['{module}'] + {flags!r} + sys.argv[1:]; "
            f"runpy.run_module('flipviscosity3d_torch.scripts.{module}', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code, "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["check"] == module and last["card"] == "cpu"
    assert not set(names) - _names(last)
    assert "flipviscosity3d_tpu" not in proc.stderr
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# ---------------------------------------------------------------------------
# solver_microbench: the systems and the solves
# ---------------------------------------------------------------------------

def _jax_systems(state, cfg, dt=solver_microbench.DT):
    """solver_microbench.py:62-116 (`assemble`), unjitted."""
    solid = state.solid
    dx = cfg.dx
    shape = cfg.grid_shape
    table_a = jbuild_buckets(
        state.pos,
        (state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
         state.vel[:, 0], state.vel[:, 1], state.vel[:, 2]),
        dx, shape, cfg.bucket_capacity,
    )
    liquid_phi, p2g_sums = jpg.p2g_and_sdf(
        table_a, shape, dx, cfg.particle_radius, solid.center_phi,
        (cfg.u_shape, cfg.v_shape, cfg.w_shape),
    )
    fluid = liquid_phi < 0
    bu, bv, bw = (face_borders_fluid_u(fluid),
                  face_borders_fluid_v(fluid),
                  face_borders_fluid_w(fluid))

    def combine(sums, borders):
        vsum, wsum = sums
        is_set = wsum >= 1e-9
        vals = vsum / jnp.maximum(wsum, 1e-9)
        mask = is_set & borders
        return jnp.where(mask, vals, 0.0), mask

    u, vu = combine(p2g_sums[0], bu)
    v, vv = combine(p2g_sums[1], bv)
    w, vw = combine(p2g_sums[2], bw)
    u, v, w, vu, vv, vw = jextrapolate(
        u, v, w, vu, vv, vw, cfg.extrapolation_layers
    )
    u = jnp.where(bu, u + state.gravity[0] * dt, u)
    v = jnp.where(bv, v + state.gravity[1] * dt, v)
    w = jnp.where(bw, w + state.gravity[2] * dt, w)

    states = jvsolver.FaceStates(solid.solid_u, solid.solid_v, solid.solid_w)
    volumes = jvsolver.compute_volume_grids(liquid_phi, cfg)
    vsys = jvsolver.build_viscosity_system(
        u, v, w, volumes, states, state.viscosity, dt, cfg
    )
    psys = jpsolver.build_pressure_system(
        u, v, w, liquid_phi, solid.weight_u, solid.weight_v,
        solid.weight_w, dt, cfg,
    )
    return vsys, psys, (u, v, w)


@pytest.fixture(scope="module")
def microbench_state():
    """solver_microbench's state at 16^3 (one warm frame), as numpy."""
    torch.set_num_threads(1)
    sim = solver_microbench.build_state("cpu", res=16, warm_frames=1)
    return sim.cfg, state_to_numpy(sim.state)


def test_solver_microbench_systems_match_jax(microbench_state):
    """build_systems on one handed state: the pressure right-hand side and
    diagonal, the row masks and the viscosity right-hand side against the
    JAX script's assembly."""
    cfg, arrays = microbench_state
    tv, tp, tuvw = solver_microbench.build_systems(
        state_from_numpy(arrays, "cpu"), cfg)
    jv, jp, juvw = _jax_systems(_jax_state(arrays), _jax_cfg(cfg))
    np.testing.assert_array_equal(tp.fluid.numpy(), np.asarray(jp.fluid))
    _close(tp.b.numpy(), jp.b)
    _close(tp.diag.numpy(), jp.diag)
    for a in range(3):
        np.testing.assert_array_equal(tv.in_mat[a].numpy(),
                                      np.asarray(jv.in_mat[a]))
        _close(tv.rhs[a].numpy(), jv.rhs[a])
        _close(tuvw[a].numpy(), juvw[a])


@pytest.mark.parametrize("name, overrides", solver_microbench.VARIANTS,
                         ids=[v[0] for v in solver_microbench.VARIANTS])
def test_solver_microbench_iterations_match_jax(microbench_state, name,
                                                overrides):
    """Both solves under each of the four variants take JAX's iteration
    counts within 1, on systems built from one handed state."""
    cfg, arrays = microbench_state
    cfg = dataclasses.replace(cfg, **overrides)
    tv, tp, tuvw = solver_microbench.build_systems(
        state_from_numpy(arrays, "cpu"), cfg)
    t_p = tpsolver.solve_pressure(tp, cfg).iterations
    t_v = tvsolver.solve_viscosity(tv, cfg, warm_start=tuvw).iterations
    jcfg = _jax_cfg(cfg)
    jv, jp, juvw = _jax_systems(_jax_state(arrays), jcfg)
    j_p = int(jpsolver.solve_pressure(jp, jcfg).iterations)
    j_v = int(jvsolver.solve_viscosity(jv, jcfg, warm_start=juvw).iterations)
    assert abs(t_p - j_p) <= 1 and abs(t_v - j_v) <= 1, (t_p, j_p, t_v, j_v)


# ---------------------------------------------------------------------------
# particle_microbench: the stream engine's passes
# ---------------------------------------------------------------------------

def test_particle_microbench_stream_passes_match_jax():
    """The four stream passes on particle_microbench's default_rng(0)
    particles at 16^3: sorted keys and payload exactly, the liquid SDF, the
    P2G sums, the samples and the pushback against the JAX script's
    (particle_microbench.py:118-134) on the same numpy inputs."""
    res = 16
    pos, vel = particle_microbench.inputs(res, 5000, 0.25)
    cfg = SimConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res)
    calls = particle_microbench.stream_calls(
        torch.from_numpy(pos), torch.from_numpy(vel), cfg)
    strm = calls[0]()
    t_phi, t_sums = calls[1](strm)
    t_two = calls[2](strm)
    t_mid, t_push = calls[3](strm)

    # particle_microbench.py:75-92, 113-134
    shape, dx = cfg.grid_shape, cfg.dx
    jp, jv = jnp.asarray(pos), jnp.asarray(vel)
    solid_phi = jnp.ones(shape, jnp.float32)
    face_shapes = (cfg.u_shape, cfg.v_shape, cfg.w_shape)
    u = jnp.zeros(cfg.u_shape, jnp.float32)
    v = jnp.zeros(cfg.v_shape, jnp.float32)
    w = jnp.zeros(cfg.w_shape, jnp.float32)
    node_phi = jnp.ones(cfg.node_shape, jnp.float32)
    payload6 = lambda p, vl: (p[:, 0], p[:, 1], p[:, 2],   # noqa: E731
                              vl[:, 0], vl[:, 1], vl[:, 2])
    s = jstream_sort(jp, payload6(jp, jv), dx, shape)
    j_phi, j_sums = jst.p2g_sdf_stream(s, shape, dx, cfg.particle_radius,
                                       solid_phi, face_shapes)
    j_two = jst.sample_mac_at(s.sorted[0], s.sorted[1], s.sorted[2], s.key,
                              [u, u], [v, v], [w, w], dx, shape)
    j_mid = jst.sample_mac_at(s.sorted[0], s.sorted[1], s.sorted[2], s.key,
                              [u], [v], [w], dx, shape)
    j_push = jst.solid_pushback_at(s.sorted[0], s.sorted[1], s.sorted[2],
                                   s.key, node_phi, dx, shape)

    np.testing.assert_array_equal(strm.key.numpy(), np.asarray(s.key))
    np.testing.assert_array_equal(strm.counts.numpy(), np.asarray(s.counts))
    for a in range(6):
        np.testing.assert_array_equal(strm.sorted[a].numpy(),
                                      np.asarray(s.sorted[a]))
    _close(t_phi.numpy(), j_phi)
    for (tvs, tws), (jvs, jws) in zip(t_sums, j_sums):
        _close(tvs.numpy(), jvs)
        _close(tws.numpy(), jws)
    for t_comp, j_comp in zip(t_two + t_mid, j_two + j_mid):
        for tg, jg in zip(t_comp, j_comp):
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for tg, jg in zip(t_push, j_push):
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# mg_pallas_bench and mg_profile: the V-cycles
# ---------------------------------------------------------------------------

def _bf16_ops(hier):
    """The hierarchy with its level operators stored in bf16, as the card
    stores them under mg_backend "pallas" (the CPU keeps f32)."""
    return dataclasses.replace(hier, ops=tuple(
        (d.to(torch.bfloat16), tuple(lk.to(torch.bfloat16) for lk in links))
        for d, links in hier.ops))


def _cycles_against_jax(diag, links, b, res, backend, **fields):
    """The module's V-cycle against JAX's v_cycle of the same hierarchy
    (mg_pallas_bench.py:40-47, mg_profile.py:72-83), both storages: f32
    under "xla", bf16 operators under "pallas" (JAX's in interpret mode)."""
    th = mg_pallas_bench.hierarchy(diag, links, res, "cpu",
                                   mg_backend=backend, **fields)
    if backend == "pallas":
        th = _bf16_ops(th)
    tb = torch.from_numpy(b)
    tout = mg_pallas_bench.kernel_cycle(th, tb)
    assert torch.equal(tout, mg_pallas_bench.plain_cycle(th, tb))
    jcfg = JaxConfig(isize=res, jsize=res, ksize=res, dx=1.0 / res,
                     mg_backend=backend, **fields)
    jh = jmg.build_hierarchy(jnp.asarray(diag),
                             tuple(jnp.asarray(lk) for lk in links), jcfg)
    assert len(jh.levels) == len(th.levels)
    jout = jmg.v_cycle(jh, jnp.asarray(b), 1, 1, mg_pallas_bench.OMEGA,
                       mg_pallas_bench.SCALE)
    np.testing.assert_allclose(tout.numpy().reshape(np.shape(jout)),
                               np.asarray(jout), **MG_TOL)
    return th


@pytest.mark.parametrize("backend", mg_pallas_bench.BACKENDS)
def test_mg_pallas_bench_cycles_match_jax(backend):
    """mg_pallas_bench's equality shapes, on its default_rng(7) operators:
    the cycle (its plain version on the CPU) equals the plain recursion and
    JAX's cycle under the same backend."""
    rng = np.random.default_rng(7)
    for shape in mg_pallas_bench.CHECK_SHAPES:
        diag, links, b = mg_pallas_bench.operators(rng, shape, 0.25)
        _cycles_against_jax(diag, links, b, 16, backend)


@pytest.mark.parametrize("backend", mg_pallas_bench.BACKENDS)
@pytest.mark.parametrize("batched", [False, True], ids=["cube", "batched"])
def test_mg_profile_cycles_match_jax(batched, backend):
    """mg_profile's V-cycle rows at 16^3, on its default_rng(0) operators
    ((16,)^3, then the batched (3, 18, 18, 18)), at each of its level caps:
    the level counts and the cycles equal JAX's."""
    rng = np.random.default_rng(0)
    ops = mg_pallas_bench.operators(rng, (16,) * 3, 0.3)
    if batched:
        ops = mg_pallas_bench.operators(rng, (3, 18, 18, 18), 0.3)
    labels = set()
    for levels in mg_profile.LEVELS:
        th = _cycles_against_jax(*ops, 16, backend, mg_max_levels=levels)
        labels.add(mg_profile.cycle_label(th))
    assert labels == ({"v_cycle L2 dense", "v_cycle L3 dense"} if batched
                      else {"v_cycle L2 dense"})


# ---------------------------------------------------------------------------
# precond_experiment: the modes' counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool_state():
    torch.set_num_threads(1)
    sim = profile_substep.pool_sim("cpu", 16)
    return sim.cfg, state_to_numpy(sim.state)


@pytest.mark.parametrize("mode", ["jacobi", "multigrid", "mixed"])
def test_precond_experiment_counts_match_jax(pool_state, mode):
    """Two frames of the pool at 16^3 from one handed state under each mode
    (with mg_max_levels 3 as an --mg-* override): equal substeps, and
    iterations per substep within 1 of the JAX package's advance."""
    cfg, arrays = pool_state
    _, ov = precond_experiment.mode_overrides(mode, {"mg_max_levels": 3})
    cfg = dataclasses.replace(cfg, **ov)
    _, sub, p_it, v_it = precond_experiment.frames_from(
        state_from_numpy(arrays, "cpu"), cfg, 2)
    jcfg, js = _jax_cfg(cfg), _jax_state(arrays)
    j_sub = j_p = j_v = 0
    for _ in range(2):
        js, d = jstep.advance(js, precond_experiment.DT, jcfg)
        j_sub += int(d.substeps)
        j_p += int(d.pressure_iterations)
        j_v += int(d.viscosity_iterations)
    assert sub == j_sub
    assert abs(p_it / sub - j_p / j_sub) <= 1
    assert abs(v_it / sub - j_v / j_sub) <= 1


# ---------------------------------------------------------------------------
# pallas_engine_probe: coverage and visits of B' and the stale pass A
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [20_000, 600_000])
def test_pallas_engine_probe_plan_counts_match_jax(n):
    """The probe's B' and stale pass-A counts at 32^3 equal JAX's
    plan_midpoint_visits / plan_pass_a (covered particles, and visits as
    the JAX script prints them, pallas_engine_probe.py:153-155, :180-182)
    on the same numpy keys: the probe's distribution moved from the sorted
    order by up to 2.5 cells. 20,000 keys take the exhaustive plan,
    600,000 the factor-capped one."""
    res = 32
    shape, dx = (res,) * 3, 1.0 / res
    rng = np.random.default_rng(5)
    lo = np.array([0.02, 0.02, 0.02])
    hi = np.array([0.98, 0.27, 0.98])
    pos = (rng.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    key = tpp.key_of_position(torch.from_numpy(pos), dx, shape)
    pos = pos[np.argsort(key.numpy(), kind="stable")]
    moved = np.clip(pos + rng.uniform(-2.5, 2.5, pos.shape) * dx, 0.001,
                    0.999).astype(np.float32)
    tkey = tpp.key_of_position(torch.from_numpy(moved), dx, shape)
    jkey = jpp.key_of_position(jnp.asarray(moved), dx, shape)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))

    b_prime = pallas_engine_probe.midpoint_counts(tkey)
    jm = jpp.plan_midpoint_visits(jkey, n, shape)
    assert b_prime["covered"] == int(np.asarray(jm.covered).sum())
    assert b_prime["visits"] == jm.lockeys.shape[1] // jpp.C
    stale = pallas_engine_probe.pass_a_counts(tkey, shape)
    jg, js = jpp.plan_pass_a(jkey, n, shape)
    assert stale["covered"] == int(np.asarray(jg.covered).sum())
    assert stale["visits"] == js.lockeys.shape[1] // jpp.C
    if n > 100_000:
        assert b_prime["covered"] < n   # the capacity cut is exercised
