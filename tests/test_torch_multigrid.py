"""The port's V-cycle pieces against the JAX package, on the CPU.

mg_down_ref / mg_up_ref (the plain versions of the mg_down / mg_up CUDA
kernels) are held against JAX's Pallas `down` / `up` in interpret mode on
f32 pad_level operators, sliced back to the real shape as the JAX V-cycle
slices them; the port's v_cycle against JAX's XLA v_cycle. Shapes are those
of tests/test_multigrid.py. Tolerance: rtol 2e-5 / atol 2e-5 (summation
order only; the coarse dense inverse comes from two LAPACK builds).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.config import SimConfig as JaxConfig
from flipviscosity3d_tpu.ops import pallas_mg as jpm
from flipviscosity3d_tpu.solvers import multigrid as jmg
from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.ops import pallas_mg as tpm
from flipviscosity3d_torch.scripts.bench import bench_scene
from flipviscosity3d_torch.solvers import multigrid as tmg

# (3, 9, 33, 17) and (1, 17, 9, 65): odd level-like extents, ragged against
# the card kernels' 16 x 16 column tiles and their even i-chunks
SHAPES = [(16, 16, 16), (3, 17, 18, 17), (3, 9, 33, 17), (1, 17, 9, 65)]
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


def test_pallas_backend_refuses_other_smoothing_in_both_packages():
    """mg_backend "pallas" with V(2,1) raises the JAX package's ValueError
    in both packages' build_hierarchy; "auto" and "xla" take it."""
    diag, links, _ = _level((16, 16, 16), seed=5)
    for pkg_cfg, build, arr in (
            (JaxConfig, jmg.build_hierarchy, jnp.asarray),
            (SimConfig, tmg.build_hierarchy, torch.from_numpy)):
        args = (arr(diag), tuple(arr(lk) for lk in links))
        cfg = pkg_cfg(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                      mg_backend="pallas", mg_pre_smooth=2)
        with pytest.raises(ValueError, match="V\\(1,1\\) smoothing only"):
            build(*args, cfg)
        for backend in ("auto", "xla"):
            ok = pkg_cfg(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                         mg_backend=backend, mg_pre_smooth=2)
            assert len(build(*args, ok).levels) == 2


@pytest.mark.parametrize("backend, dtype, fine, device, want", [
    ("auto", "bf16", (1, 128, 128, 128), "cuda", torch.bfloat16),
    ("auto", "bf16", (3, 257, 257, 257), "cuda", torch.bfloat16),
    ("auto", "bf16", (3, 513, 261, 261), "cuda", torch.float32),
    ("auto", "bf16", (1, 512, 512, 512), "cuda", torch.float32),
    ("xla", "bf16", (1, 128, 128, 128), "cuda", torch.float32),
    ("pallas", "bf16", (1, 512, 512, 512), "cuda", torch.bfloat16),
    ("auto", "f32", (1, 128, 128, 128), "cuda", torch.float32),
    ("pallas", "bf16", (1, 128, 128, 128), "cpu", torch.float32),
], ids=str)
def test_storage_dtype_follows_the_jax_backend(backend, dtype, fine, device,
                                               want):
    """The level operators' storage on the card: mg_operator_dtype, except
    f32 under "xla" (the JAX XLA cycle's f32 levels) and under "auto" past
    the JAX package's 260 x 260 fine plane; f32 on the CPU. A
    torch.device("cuda") object needs no card."""
    cfg = SimConfig(mg_backend=backend, mg_operator_dtype=dtype)
    assert tmg._storage_dtype(cfg, torch.device(device), fine) == want


def test_xla_backend_keeps_the_cycle_on_the_cpu():
    """Under every backend the port runs the same V(1,1) cycle through the
    mg_down / mg_up plain versions on the CPU: equal outputs."""
    diag, links, b = _level((3, 9, 33, 17), seed=9)
    outs = []
    for backend in ("auto", "xla", "pallas"):
        cfg = SimConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16,
                        mg_backend=backend)
        th = tmg.build_hierarchy(torch.from_numpy(diag),
                                 tuple(torch.from_numpy(lk) for lk in links),
                                 cfg)
        assert th.ops is not None
        outs.append(tmg.v_cycle(th, torch.from_numpy(b), 1, 1, OMEGA, SCALE))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_plane_chunk_gives_even_chunks_and_enough_waves():
    """The kernels' i-chunk (ops/pallas_mg.plane_chunk) on the H100's 132
    SMs at every level of both hierarchies at 128^3 and 256^3: even, at
    least 4, at most I rounded up to even (or 4), and about eight waves of
    4 blocks per SM wherever a level has the planes for them."""
    cfg = SimConfig()
    for res in (128, 256):
        for shapes in smoke.vcycle_level_shapes((res,) * 3, cfg).values():
            for nb, ni, nj, nk in shapes:
                c = tpm.plane_chunk((nb, ni, nj, nk), 132)
                assert c >= 4 and c % 2 == 0 and c <= max(4, ni + ni % 2)
                blocks = nb * -(-ni // c) * -(-nj // 16) * -(-nk // 16)
                if c > 4:
                    # (rounding the chunk up to even costs at most half)
                    assert 2 * blocks >= 8 * 4 * 132, (nb, ni, nj, nk)
    assert tpm.plane_chunk((3, 129, 129, 129), 132) == 8
    assert tpm.plane_chunk((1, 128, 128, 128), 132) == 4
    assert tpm.plane_chunk((3, 257, 257, 257), 132) == 52
    assert tpm.plane_chunk((1, 256, 256, 256), 132) == 16


def test_vcycle_records_run_on_cpu():
    """smoke._vcycle_records, which chip_smoke.py runs on the card at 128^3
    and 256^3, at 16^3 on CPU tensors (plain versions both sides): one line
    per level above the coarsest of both hierarchies, every check equal,
    the viscosity fine level's times and bound in the records."""
    cfg = SimConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16)
    gen = torch.Generator()
    gen.manual_seed(0)
    recs = smoke._vcycle_records(cfg, torch.device("cpu"), gen)
    levels = recs["mg_down"][1]["levels"]
    assert [(ln["system"], tuple(ln["shape"])) for ln in levels] == [
        ("pressure", (1, 16, 16, 16)), ("viscosity", (3, 17, 17, 17)),
        ("viscosity", (3, 9, 9, 9))]
    for name in ("mg_down", "mg_up"):
        checks, times, bnd = recs[name]
        assert all(c["ok"] for c in checks)
        assert bnd["bound_by"] == "bytes"
        assert bnd["bound_ms"] == levels[1][name]["bound_ms"]
        assert times["ms"] > 0
    assert levels[1]["mg_down"]["bytes"] == 3 * 17 ** 3 * 24 + 3 * 9 ** 3 * 4


def test_mg_levels_script_runs_on_cpu_without_jax():
    """scripts/mg_levels.py as its command line runs it, here with --device
    cpu at 16^3 (plain versions both sides) and JAX made unimportable: one
    line per level above the coarsest, each equal, exit 0."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "flipviscosity3d_torch", "scripts",
                          "mg_levels.py")
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            f"sys.argv = [{script!r}, '--device', 'cpu', '--res', '16']; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=repo)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.splitlines()]
    assert [(ln["system"], ln["shape"]) for ln in lines] == [
        ("pressure", [1, 16, 16, 16]), ("viscosity", [3, 17, 17, 17]),
        ("viscosity", [3, 9, 9, 9])]
    assert all(ln[k]["equal"] for ln in lines for k in ("mg_down", "mg_up"))


def test_a_frame_leaves_no_hierarchy_to_the_collector():
    """A frame of the bench scene at 16^3 leaves no reference cycle that
    holds a hierarchy or a tensor: each solve's levels are freed when the
    solve ends, not when Python's collector next runs (a V-cycle closure
    that called itself once kept them)."""
    sim = bench_scene("cpu", 16)
    sim.advance(0.01)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        sim.advance(0.01)
        gc.collect()
        found = [o for o in gc.garbage
                 if isinstance(o, (torch.Tensor, tmg.MGHierarchy))]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if enabled:
            gc.enable()
    assert found == []
