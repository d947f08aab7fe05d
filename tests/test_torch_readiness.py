"""The port's readiness checks (flipviscosity3d_torch/scripts/readiness256.py
and readiness512.py) at small sizes on the CPU, against the JAX package.

readiness256 at 32^3 with 4,000 particles: its analytic solid SDF against
the closed form of the JAX script (readiness256.py:36-56, git blob 03f1f87
as of commit db376e7, written out below), atol 1e-6; then one substep of
the "pallas" engine from the state the module builds, handed to both
packages as numpy arrays, against JAX's core/step.step (its Pallas kernels
in interpret mode): the same overflow, iterations within 1, the mean
height within 1e-5.

readiness512 at RES 32 on 4 slab ranks with 5,000 particles against JAX's
advance_sharded on 4 of the conftest's forced host devices, set up as the
JAX script sets it up (readiness512.py:89-112, git blob 7e6c7ef): no
particle lost in either, equal substeps, pressure iterations within 1.
The viscosity counts differ by design: the port's slab hierarchy counts
the single-device blocks' padding row, JAX's leaves it out (ROADMAP Queue
3); with that row left out of the port's too its count is JAX's within 1,
and the gap is what the row makes, as
tests/test_torch_shard_step.py::test_multigrid_sharded_step_against_jax
witnesses it. Then the ISIZE form at RES 32: isize = 4 * B with the
smallest slab width B that make_spec accepts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.parallel import shard_step as sh
from flipviscosity3d_torch.parallel import slab_mg
from flipviscosity3d_torch.scripts import readiness256, readiness512
from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.core import step as jstep
from flipviscosity3d_tpu.parallel import shard_step as jsh
from test_torch_step import _jax_state

NDEV = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_cfg(cfg):
    return JaxConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})


def _quiet(line):
    pass


def _jax_analytic_sdf(cfg):
    """readiness256.py:36-56's closed form (its `build`), unjitted."""
    inset = 0.5 * (3.0 * cfg.dx + 1e-6)
    lo = jnp.full((3,), inset, jnp.float32)
    hi = (jnp.array([cfg.isize, cfg.jsize, cfg.ksize], jnp.float32)
          * cfg.dx - inset)
    axes = [jnp.arange(s + 1, dtype=jnp.float32) * cfg.dx
            for s in (cfg.isize, cfg.jsize, cfg.ksize)]
    p = jnp.stack(jnp.meshgrid(*axes, indexing="ij"), axis=-1)
    q = jnp.maximum(lo - p, p - hi)
    outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return -(outside + inside)


def test_readiness256_substep_matches_jax():
    res, npart = 32, 4000
    state, cfg = readiness256.build_state("cpu", res, npart, "pallas")
    assert cfg.particle_engine == "pallas" and cfg.bucket_capacity == 8
    np.testing.assert_allclose(
        readiness256.analytic_boundary_sdf(cfg, "cpu").phi.numpy(),
        np.asarray(_jax_analytic_sdf(cfg)), rtol=0, atol=1e-6)
    arrays = state_to_numpy(state)
    dt = np.float32(readiness256.DT)
    tnew, td = tstep.step(state_from_numpy(arrays, "cpu"), float(dt), cfg)
    jnew, jd = jstep.step(_jax_state(arrays), jnp.float32(dt),
                          _jax_cfg(cfg))
    assert int(td["bucket_overflow"]) == int(jd["bucket_overflow"])
    for k in ("pressure_iterations", "viscosity_iterations"):
        assert abs(int(td[k]) - int(jd[k])) <= 1, (k, td[k], jd[k])
    t_com = float(tnew.pos[:, 1].mean())
    j_com = float(jnp.mean(jnew.pos[:, 1]))
    assert abs(t_com - j_com) <= 1e-5
    # the module's own run repeats the substep on the same state
    result = readiness256.run("cpu", res, npart, log=_quiet)
    assert result["ok"] and result["com_y"] == t_com
    assert result["overflow"] == int(td["bucket_overflow"])


def _jax_readiness512(res, npart, isize):
    """readiness512.py:89-112 on 4 forced host devices: (alive, diag)."""
    cfg = SimConfig(isize=isize, jsize=res, ksize=res, dx=1.0 / res)
    pos = torch.from_numpy(readiness512.particles(res, isize, npart))
    arrays = state_to_numpy(
        readiness256.readiness_sim("cpu", cfg, 1.0, pos).state)
    jcfg = _jax_cfg(cfg)
    spec = jsh.make_spec(jcfg, NDEV, cap_factor=2.0, n_particles=npart)
    ss = jsh.shard_simstate(_jax_state(arrays), jcfg, spec)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (jsh.AXIS,))
    ss, diag = jsh.advance_sharded(ss, readiness512.DT, jcfg, spec, mesh)
    pos_out, _ = jsh.gather_particles(ss)
    assert np.isfinite(np.asarray(pos_out)).all()
    return int(np.asarray(ss.alive).sum()), diag


def test_readiness512_substep_matches_jax(monkeypatch):
    res, npart = 32, 5000
    result = readiness512.run("cpu", res, npart, NDEV, log=_quiet)
    assert result["ok"] and result["alive"] == npart
    assert result["migration_lost"] == 0
    assert result["slab_shape"] == [8 + 2 * 6, res, res]
    alive, jd = _jax_readiness512(res, npart, res)
    assert alive == npart
    assert result["substeps"] == int(jd.substeps) == 1
    assert abs(result["pressure_iters"] - int(jd.pressure_iterations)) <= 1
    build = slab_mg.build_slab_hierarchy
    monkeypatch.setattr(
        slab_mg, "build_slab_hierarchy",
        lambda diag, links, cfg, group, extra_rows=0: build(
            diag, links, cfg, group))
    without_row = readiness512.run("cpu", res, npart, NDEV, log=_quiet)
    jv = int(jd.viscosity_iterations)
    assert abs(without_row["viscosity_iters"] - jv) <= 1
    assert abs(result["viscosity_iters"] - jv) == abs(
        result["viscosity_iters"] - without_row["viscosity_iters"])


def _accepts(b: int) -> bool:
    try:
        sh.make_spec(SimConfig(isize=NDEV * b, jsize=32, ksize=32,
                               dx=1.0 / 32), NDEV, n_particles=5000)
    except ValueError:
        return False
    return True


def test_readiness512_isize_form_runs():
    """ISIZE = 4 B with the smallest B make_spec accepts: the slabs keep
    the full grid's (B + 2H, 32, 32) shape; no particle lost."""
    b = next(b for b in range(1, 32) if _accepts(b))
    result = readiness512.run("cpu", 32, 5000, NDEV, isize=NDEV * b,
                              log=_quiet)
    assert result["ok"] and result["alive"] == 5000
    assert result["isize"] == NDEV * b
    assert result["slab_shape"] == [b + 2 * 6, 32, 32]
    assert result["substeps"] == 1
