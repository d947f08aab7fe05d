"""The port's V-cycle pieces against the JAX package, on the CPU.

mg_down_ref / mg_up_ref (the plain versions of the mg_down / mg_up CUDA
kernels) are held against JAX's Pallas `down` / `up` in interpret mode on
f32 pad_level operators, sliced back to the real shape as the JAX V-cycle
slices them; the port's v_cycle against JAX's XLA v_cycle. Shapes are those
of tests/test_multigrid.py. Tolerance: rtol 2e-5 / atol 2e-5 (summation
order only; the coarse dense inverse comes from two LAPACK builds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.ops import pallas_mg as jpm
from flipviscosity3d_tpu.solvers import multigrid as jmg
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.ops import pallas_mg as tpm
from flipviscosity3d_torch.solvers import multigrid as tmg

SHAPES = [(16, 16, 16), (3, 17, 18, 17)]
OMEGA, SCALE = 0.8, 1.4
TOL = dict(rtol=2e-5, atol=2e-5)


def _level(shape, seed=7):
    """Random diagonally dominant operator with zero edge links (as in the
    premasked systems) and a right-hand side."""
    rng = np.random.default_rng(seed)
    diag = rng.uniform(1, 2, shape).astype(np.float32)
    links = []
    for ax in range(3):
        lk = rng.uniform(0, 0.25, shape).astype(np.float32)
        idx = [slice(None)] * len(shape)
        idx[len(shape) - 3 + ax] = -1
        lk[tuple(idx)] = 0.0
        links.append(lk)
    b = rng.normal(size=shape).astype(np.float32)
    return diag, links, b


def _batched(a):
    return a if a.ndim == 4 else a[None]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mg_down_and_up_refs_match_jax_kernels(shape):
    diag, links, b = _level(shape)
    diag, b = _batched(diag), _batched(b)
    links = [_batched(lk) for lk in links]
    nb, ni, nj, nk = b.shape
    bi = 4
    diag_p, links_p = jpm.pad_level(jnp.asarray(diag),
                                    tuple(jnp.asarray(lk) for lk in links),
                                    bi, dtype=jnp.float32)
    _, pi, pj, pk = diag_p.shape
    b_p = jnp.pad(jnp.asarray(b),
                  ((0, 0), (bi, pi - ni - bi), (0, pj - nj), (0, pk - nk)))
    x_p, rc_p = jpm.down(diag_p, links_p, b_p, OMEGA, bi)
    ci, cj, ck = (ni + 1) // 2, (nj + 1) // 2, (nk + 1) // 2
    jx = np.asarray(x_p)[:, bi:bi + ni, :nj, :nk]
    jrc = np.asarray(rc_p)[:, bi // 2:bi // 2 + ci, :cj, :ck]

    td, tl, tb = (torch.from_numpy(diag),
                  tuple(torch.from_numpy(lk) for lk in links),
                  torch.from_numpy(b))
    tx, trc = tpm.mg_down(td, tl, tb, OMEGA)   # CPU tensors: plain version
    np.testing.assert_allclose(tx.numpy(), jx, **TOL)
    np.testing.assert_allclose(trc.numpy(), jrc, **TOL)

    xc = np.random.default_rng(3).normal(size=(nb, ci, cj, ck)).astype(
        np.float32)
    xc_p = jnp.pad(jnp.asarray(xc), (
        (0, 0), (bi // 2, rc_p.shape[1] - ci - bi // 2),
        (0, rc_p.shape[2] - cj), (0, rc_p.shape[3] - ck)))
    j_up = np.asarray(jpm.up(diag_p, links_p, b_p, x_p, xc_p, OMEGA, SCALE,
                             bi))[:, bi:bi + ni, :nj, :nk]
    t_up = tpm.mg_up(td, tl, tb, tx, torch.from_numpy(xc), OMEGA, SCALE)
    np.testing.assert_allclose(t_up.numpy(), j_up, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_v_cycle_matches_jax_xla_cycle(shape):
    diag, links, b = _level(shape)
    jcfg = JaxConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                     mg_backend="xla")
    tcfg = SimConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16)
    jh = jax.jit(lambda d, lk: jmg.build_hierarchy(d, lk, jcfg))(
        jnp.asarray(diag), tuple(jnp.asarray(lk) for lk in links))
    th = tmg.build_hierarchy(torch.from_numpy(diag),
                             tuple(torch.from_numpy(lk) for lk in links),
                             tcfg)
    assert len(th.levels) == len(jh.levels)
    for jl, tl in zip(jh.levels, th.levels):
        np.testing.assert_allclose(tl.diag.numpy(),
                                   _batched(np.asarray(jl.diag)), **TOL)
        for ax in range(3):
            np.testing.assert_allclose(tl.links[ax].numpy(),
                                       _batched(np.asarray(jl.links[ax])),
                                       **TOL)
    assert th.ops[0][0].dtype == torch.float32   # CPU stores f32 operators
    jout = np.asarray(jax.jit(
        lambda h, b: jmg.v_cycle(h, b, 1, 1, OMEGA, SCALE))(
            jh, jnp.asarray(b)))
    tout = tmg.v_cycle(th, torch.from_numpy(b), 1, 1, OMEGA, SCALE).numpy()
    np.testing.assert_allclose(tout, jout, **TOL)


def test_v_cycle_other_smoothing_counts_match_jax():
    """V(2,1) takes the generic smoothing loop, not the fused levels."""
    diag, links, b = _level((16, 16, 16), seed=11)
    jcfg = JaxConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                     mg_backend="xla", mg_pre_smooth=2)
    tcfg = SimConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                     mg_pre_smooth=2)
    jout = np.asarray(jax.jit(lambda d, lk, b: jmg.v_cycle(
        jmg.build_hierarchy(d, lk, jcfg), b, 2, 1, OMEGA, SCALE))(
            jnp.asarray(diag), tuple(jnp.asarray(lk) for lk in links),
            jnp.asarray(b)))
    th = tmg.build_hierarchy(torch.from_numpy(diag),
                             tuple(torch.from_numpy(lk) for lk in links),
                             tcfg)
    assert th.ops is None
    tout = tmg.v_cycle(th, torch.from_numpy(b), 2, 1, OMEGA, SCALE).numpy()
    np.testing.assert_allclose(tout, jout, **TOL)
