"""The port's particle engine against the JAX package, on the CPU.

The plain versions of the two particle CUDA kernels (scatter_p2g_table_ref,
gather_mac_ref) are held against JAX's Pallas kernels in interpret mode,
which on the CPU run one exact f32 dot per one-hot contraction
(pallas_particles.py:111-115): tolerances cover summation order only.
Keys, ranks and decodes are integers and must match exactly.

At pallas_split_terms 1 and 2 the JAX kernels round their values to bf16
terms, which turns a difference of one f32 ulp in a value into one of a
bf16 term's ulp. XLA's CPU code contracts multiply-adds into fused
multiply-adds where the processor has them, and so moves about a fifth of
the Wyvill weights by an ulp from the unfused arithmetic of the kernels'
expressions (the port's and, on the TPU, JAX's). The split-terms test
therefore takes JAX's results from a second process whose XLA may not use
FMA instructions (--xla_cpu_max_isa=AVX).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.ops import buckets as jbk
from flipviscosity3d_tpu.ops import pallas_particles as jpp
from flipviscosity3d_tpu.ops import stream_transfers as jst
from flipviscosity3d_torch.ops import buckets as tbk
from flipviscosity3d_torch.ops import pallas_particles as tpp
from flipviscosity3d_torch.ops import stream_transfers as tst
from flipviscosity3d_torch.ops.particle_grid import liquid_sdf_from_particles

SHAPE = (16, 16, 16)
DX = 1.0 / 16
FACES = ((17, 16, 16), (16, 17, 16), (16, 16, 17))
RADIUS = DX * 1.01 * (3.0 ** 0.5) / 2.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _particles(n=3000, seed=11, spread=0.9):
    """Clustered positions (several per cell, so ranks reach the cap) and
    velocities; spread > 1 puts some positions outside the domain."""
    rng = np.random.default_rng(seed)
    centers = rng.random((n // 25, 3)) * 0.8 + 0.1
    pos = centers[rng.integers(0, len(centers), n)] + rng.normal(
        scale=0.006, size=(n, 3))
    pos = (0.5 + (pos - 0.5) * spread).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return pos, vel


def test_keys_decode_sort_and_ranks_match_jax_exactly():
    pos, vel = _particles(spread=1.2)
    jkey = np.asarray(jpp.key_of_position(jnp.asarray(pos), DX, SHAPE))
    tkey = tpp.key_of_position(torch.from_numpy(pos), DX, SHAPE)
    np.testing.assert_array_equal(tkey.numpy(), jkey)
    for jd, td in zip(jpp.decode_key(jnp.asarray(jkey), SHAPE),
                      tpp.decode_key(tkey, SHAPE)):
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(
        tbk.cell_of_position(torch.from_numpy(pos), DX, SHAPE).numpy(),
        np.asarray(jbk.cell_of_position(jnp.asarray(pos), DX, SHAPE)))

    js = jpp.tiled_sort(jnp.asarray(pos), jnp.asarray(vel), DX, SHAPE)
    ts = tpp.tiled_sort(torch.from_numpy(pos), torch.from_numpy(vel), DX,
                        SHAPE)
    np.testing.assert_array_equal(ts.key.numpy(), np.asarray(js.key))
    np.testing.assert_array_equal(ts.rank.numpy(), np.asarray(js.rank))
    np.testing.assert_array_equal(
        ts.pos.numpy(), np.stack([np.asarray(a) for a in js.sorted[:3]], 1))
    np.testing.assert_array_equal(
        ts.vel.numpy(), np.stack([np.asarray(a) for a in js.sorted[3:]], 1))
    assert ts.rank.max() >= 16   # the cap below really drops particles


@pytest.mark.parametrize("cap", [4, 16])
def test_scatter_ref_matches_jax_kernel(cap):
    """Sums rtol 1e-5 / atol 1e-6 * max|sums|; the slot table exact on the
    first cap*4 lanes of each cell; the overflow count equal. Also the
    downstream SDF sweep and face combine."""
    pos, vel = _particles()
    js = jpp.tiled_sort(jnp.asarray(pos), jnp.asarray(vel), DX, SHAPE)
    jsums, jtbl = jpp.scatter_p2g_table(
        js.plan.tabs, js.plan.lockeys, js.payload, SHAPE, DX, cap)
    ts = tpp.tiled_sort(torch.from_numpy(pos), torch.from_numpy(vel), DX,
                        SHAPE)
    tsums, ttbl = tpp.scatter_p2g_table(ts.pos, ts.vel, ts.key, ts.rank,
                                        SHAPE, DX, cap)
    jsums = np.asarray(jsums)
    np.testing.assert_allclose(tsums.numpy(), jsums, rtol=1e-5,
                               atol=1e-6 * np.abs(jsums).max())
    jtbl = np.asarray(jtbl).reshape(*SHAPE, -1)[..., :cap * 4]
    np.testing.assert_array_equal(ttbl.numpy().reshape(*SHAPE, cap * 4),
                                  jtbl)
    assert int((ts.rank >= cap).sum()) == int(jnp.sum(js.rank >= cap))

    center_phi = np.random.default_rng(2).normal(
        scale=0.05, size=SHAPE).astype(np.float32)
    jphi = jpp.liquid_sdf_from_fields(
        jpp.table_fields(jnp.asarray(np.asarray(jtbl).reshape(
            SHAPE[0], SHAPE[1], -1)), SHAPE, cap),
        SHAPE, DX, RADIUS, jnp.asarray(center_phi))
    tphi = liquid_sdf_from_particles(tpp.table_fields(ttbl, cap), SHAPE, DX,
                                     RADIUS, torch.from_numpy(center_phi))
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=1e-6,
                               atol=1e-7)

    jcomb = jpp.p2g_combine(jnp.asarray(jsums), SHAPE, FACES)
    tcomb = tpp.p2g_combine(tsums, SHAPE, FACES)
    for (jv, jw), (tv, tw) in zip(jcomb, tcomb):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6 * np.abs(jsums).max())
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6 * np.abs(jsums).max())


@pytest.mark.parametrize("n_grids", [1, 2])
def test_gather_ref_matches_jax_kernel(n_grids):
    """Positions partly outside the domain (the midpoint case: the home key
    is clamped, corners outside the window weigh 0): rtol 1e-5 /
    atol 1e-6."""
    pos, _ = _particles(spread=1.3)
    assert ((pos < 0) | (pos >= 1)).any()
    rng = np.random.default_rng(4)
    grids = [[rng.normal(size=fs).astype(np.float32) for fs in FACES]
             for _ in range(n_grids)]
    key = jpp.key_of_position(jnp.asarray(pos), DX, SHAPE)
    key_s, (bx, by, bz), plan = jpp.sort_by_key(
        key, tuple(jnp.asarray(pos[:, a]) for a in range(3)), SHAPE)
    pay = jpp.gather_payload(bx, by, bz, key_s, SHAPE)
    cols = jpp.build_mac_columns(
        *([jnp.asarray(g[c]) for g in grids] for c in range(3)), SHAPE)
    jout = np.asarray(jpp.gather_mac(plan.tabs, plan.lockeys, pay, cols,
                                     pos.shape[0], DX, n_grids))
    tout = tpp.gather_mac(
        *(torch.from_numpy(np.array(a)) for a in (bx, by, bz, key_s)),
        *([torch.from_numpy(g[c]) for g in grids] for c in range(3)),
        DX, SHAPE)
    assert tout.shape == (3 * n_grids, pos.shape[0])
    np.testing.assert_allclose(tout.numpy(), jout[:3 * n_grids], rtol=1e-5,
                               atol=1e-6)


def test_solid_pushback_matches_jax():
    """Positions inside the clamp box, node SDF with solid regions:
    displacements to 1e-6."""
    rng = np.random.default_rng(9)
    pos = (rng.random((2000, 3)) * 0.86 + 0.07).astype(np.float32)
    phi = rng.normal(scale=0.05, size=(17, 17, 17)).astype(np.float32)
    jkey = jbk.cell_of_position(jnp.asarray(pos), DX, SHAPE)
    jd = jst.solid_pushback_at(*(jnp.asarray(pos[:, a]) for a in range(3)),
                               jkey, jnp.asarray(phi), DX, SHAPE)
    tkey = tbk.cell_of_position(torch.from_numpy(pos), DX, SHAPE)
    td = tst.solid_pushback_at(
        *(torch.from_numpy(pos[:, a].copy()) for a in range(3)), tkey,
        torch.from_numpy(phi), DX, SHAPE)
    for j, t in zip(jd, td):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    assert any(np.abs(np.asarray(j)).max() > 0 for j in jd)


def jax_split_outputs(terms: int, out: str) -> None:
    """JAX's interpret-mode kernels at `terms` on _particles(): the scatter
    of the sorted stream (cap 4), the scatter with in-kernel ranks over the
    stream as it is (plan_pass_a's plan, every particle covered), and the
    MAC gather of 1 and 2 grids at positions partly outside the domain,
    sorted by key -> an npz at `out`."""
    pos, vel = _particles()
    js = jpp.tiled_sort(jnp.asarray(pos), jnp.asarray(vel), DX, SHAPE)
    res = dict(zip(("sorted_sums", "sorted_table"), jpp.scatter_p2g_table(
        js.plan.tabs, js.plan.lockeys, js.payload, SHAPE, DX, 4,
        terms=terms)))
    key = jpp.key_of_position(jnp.asarray(pos), DX, SHAPE)
    gplan, splan = jpp.plan_pass_a(key, pos.shape[0], SHAPE, 8, 3.0)
    assert bool(jnp.all(gplan.covered))
    res.update(zip(("stale_sums", "stale_table"), jpp.scatter_p2g_table(
        splan.tabs, splan.lockeys,
        jpp.stale_payload(jnp.asarray(pos), jnp.asarray(vel), key, SHAPE),
        SHAPE, DX, 4, terms=terms, inkernel_rank=True)))
    gpos, grids = _gather_inputs()
    key = jpp.key_of_position(jnp.asarray(gpos), DX, SHAPE)
    key_s, (bx, by, bz), plan = jpp.sort_by_key(
        key, tuple(jnp.asarray(gpos[:, a]) for a in range(3)), SHAPE)
    pay = jpp.gather_payload(bx, by, bz, key_s, SHAPE)
    for n_grids in (1, 2):
        cols = jpp.build_mac_columns(
            *([jnp.asarray(g[c]) for g in grids[:n_grids]]
              for c in range(3)), SHAPE)
        res[f"gather{n_grids}"] = jpp.gather_mac(
            plan.tabs, plan.lockeys, pay, cols, gpos.shape[0], DX, n_grids,
            terms=terms)[:3 * n_grids]
    res["gather_keys"] = key_s
    res["gather_pos"] = jnp.stack([bx, by, bz])
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


def _gather_inputs():
    """Positions partly outside the domain and two grids per component."""
    pos, _ = _particles(spread=1.3)
    rng = np.random.default_rng(4)
    return pos, [[rng.normal(size=fs).astype(np.float32) for fs in FACES]
                 for _ in range(2)]


def _port_split_outputs(terms):
    """The port's plain versions on the inputs of jax_split_outputs."""
    pos, vel = _particles()
    tp, tv = torch.from_numpy(pos), torch.from_numpy(vel)
    ts = tpp.tiled_sort(tp, tv, DX, SHAPE)
    res = dict(zip(("sorted_sums", "sorted_table"), tpp.scatter_p2g_table(
        ts.pos, ts.vel, ts.key, ts.rank, SHAPE, DX, 4, terms=terms)))
    key = tpp.key_of_position(tp, DX, SHAPE)
    plan = tpp.plan_pass_a(key, SHAPE, 8, 3.0)
    res.update(zip(("stale_sums", "stale_table"),
                   tpp.scatter_p2g_table_stale(tp, tv, key, plan, SHAPE, DX,
                                               4, terms=terms)[:2]))
    _, grids = _gather_inputs()
    return res, grids


@pytest.mark.parametrize("terms", [1, 2])
def test_split_terms_round_like_jax(terms, tmp_path):
    """At pallas_split_terms 1 and 2 the port's plain scatter (sorted, and
    with in-kernel ranks) and plain gather (1 and 2 grids) against JAX's
    interpret-mode kernels at the same terms (module docstring: from a
    process without FMA): sums and samples within rtol 1e-5 (sums atol
    1e-6 * max|sums|, samples atol 1e-6), tables exact. The rounding shows:
    for every output, the port at `terms` differs from the port's exact
    products (terms 3) by at least 10 times its difference from JAX at
    `terms`."""
    out = str(tmp_path / "jax.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip())
    code = (f"import sys; sys.path[:0] = [{here!r}, {os.path.dirname(here)!r}]"
            f"; import test_torch_particles as t; "
            f"t.jax_split_outputs({terms}, {out!r})")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out) as data:
        jax_out = dict(data)
    port, grids = _port_split_outputs(terms)
    exact, _ = _port_split_outputs(3)
    keys = torch.from_numpy(jax_out["gather_keys"])
    gpos = [torch.from_numpy(a.copy()) for a in jax_out["gather_pos"]]
    for n_grids in (1, 2):
        args = (*gpos, keys, *([torch.from_numpy(g[c]) for g in
                                grids[:n_grids]] for c in range(3)), DX,
                SHAPE)
        port[f"gather{n_grids}"] = tpp.gather_mac(*args, terms=terms)
        exact[f"gather{n_grids}"] = tpp.gather_mac(*args)
    for name, want in jax_out.items():
        if name.startswith("gather_"):
            continue
        got = port[name].numpy()
        if name.endswith("table"):
            want = want.reshape(*SHAPE, -1)[..., :16]
            np.testing.assert_array_equal(got.reshape(*SHAPE, 16), want,
                                          err_msg=name)
            continue
        atol = 1e-6 * (np.abs(want).max() if "sums" in name else 1.0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=name)
        off_jax = np.abs(got - want).max()
        rounding = np.abs(got - exact[name].numpy()).max()
        assert rounding >= 10.0 * off_jax, (name, rounding, off_jax)
        assert rounding > 0.0, name


def test_particle_kernels_script_runs_on_cpu_without_jax():
    """scripts/particle_kernels.py as its command line runs it, here with
    --device cpu at 16^3 (plain versions) and this checkout as --root too
    (imported a second time under another name), JAX made unimportable,
    torch on one thread (as the other CPU tests run it): one line per
    package and kernel case (K1, K2, K5 at both strides and split terms 3,
    1, 2 on two stale orders, K11), then checks that all hold, exit 0."""
    import json

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "flipviscosity3d_torch", "scripts",
                          "particle_kernels.py")
    code = ("import sys, runpy, torch; sys.modules['jax'] = None; "
            "torch.set_num_threads(1); "
            f"sys.argv = [{script!r}, '--device', 'cpu', '--res', '16', "
            f"'--root', {repo!r}]; "
            f"runpy.run_path({script!r}, run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=repo)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.splitlines()]
    stale = [(name, order, terms)
             for order in ("falling", "random steps")
             for name in ("scatter_p2g_table_stale",
                          "scatter_p2g_table_stale_folded")
             for terms in (3, 1, 2)]
    kernels = [(name, None, None) for name in (
        "scatter_p2g_table", "scatter_p2g_table_folded", "gather_mac",
        "gather_mac_one_grid")] + stale + [("tile_scatter", None, None)]
    assert [(ln["kernel"], ln.get("order"), ln.get("terms"))
            for ln in lines[:-1]] == kernels * 2
    assert all(len(ln["ms"]) == 2 and ln["bound_ms"] > 0
               for ln in lines[:-1])
    checks = lines[-1]["checks"]
    assert lines[-1]["ok"] and len(checks) == 27
    assert all(c["ok"] for c in checks)
