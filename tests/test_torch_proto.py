"""The port's round-1 prototype module against the JAX package's
scripts/pallas_particle_proto.py, on the CPU.

The JAX script is imported from its file unchanged, and its two Pallas
kernels run in TPU interpret mode (pltpu.force_tpu_interpret_mode). Both
modules are fed the same arrays: make_scene draws with numpy from a seed,
and the kernels take the JAX sort's payload. On the CPU the JAX kernels'
one-hot products at precision HIGHEST are exact float32, so the scatter's
tolerance covers the order of summation only.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flipviscosity3d_torch.scripts import pallas_particle_proto as tproto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jproto():
    """scripts/pallas_particle_proto.py as a module. Importing it points
    JAX's compilation cache into /tmp; the setting is restored after."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "jax_pallas_particle_proto",
        os.path.join(REPO, "scripts", "pallas_particle_proto.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    jax.config.update("jax_compilation_cache_dir", before)
    return module


# (res, fill, particles per cell, seed): the JAX script's two check scenes
# and the bench pool at 32^3
SCENES = [(16, 0.5, 4, 1), (16, 0.5, 4, 2), (32, 0.27, 8, 0)]


def _sorted_both(jproto, res, fill, ppc, seed, keep=None):
    """Both packages' sort of one make_scene (its first `keep` particles)
    -> (N, dx, shape, JAX's (payload, starts, spans) as numpy, the port's
    as tensors)."""
    pos, vel, dx, shape = tproto.make_scene(res, fill, ppc, seed)
    jpos, jvel, jdx, jshape = jproto.make_scene(res, fill, ppc, seed)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(vel, jvel)
    assert (dx, shape) == (jdx, jshape)
    pos, vel = pos[:keep], vel[:keep]
    jout = jproto.sort_particles(jnp.asarray(pos), jnp.asarray(vel), dx,
                                 shape)
    tout = tproto.sort_particles(torch.from_numpy(pos),
                                 torch.from_numpy(vel), dx, shape)
    return pos.shape[0], dx, shape, [np.array(a) for a in jout], tout


def _check_sort_particles(jproto, scene):
    """The payload (keys, ranks and pads too), the tiles' run starts and
    the chunks' tile spans equal the JAX script's exactly."""
    _, _, _, jout, tout = _sorted_both(jproto, *scene)
    for name, j, t in zip(("payload", "starts", "spans"), jout, tout):
        assert t.dtype == (torch.float32 if name == "payload"
                           else torch.int32), name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


def _check_plain_scatter(jproto, cap):
    """tile_scatter's plain version against make_scatter_kernel in
    interpret mode on the bench pool at 32^3 (8 per cell, so every cell
    overflows a cap of 4): the slot table (occupancy and positions) equal;
    the 108 sums to rtol 1e-5 and atol 1e-6 of their largest magnitude, the
    tolerance the port holds K1's sums to (XLA's CPU code may contract the
    weight polynomial's products into fused multiply-adds, so single
    weights differ by an ulp, and the weight * velocity sums cancel)."""
    n, dx, shape, (payload, starts, _), _ = _sorted_both(jproto, *SCENES[2])
    n_blocks = tproto.n_blocks_of(shape)
    nt = tproto.tile_counts(shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jproto.make_scatter_kernel(n_blocks, nt, dx, cap)(
            jnp.asarray(starts), jnp.asarray(payload)))
    got = tproto.make_scatter_kernel(n_blocks, nt, dx, cap)(
        torch.from_numpy(starts), torch.from_numpy(payload)).numpy()
    assert got.shape == want.shape == (n_blocks, tproto.W, 108 + 4 * cap)
    np.testing.assert_array_equal(got[..., 108:], want[..., 108:])
    occupied = got[..., 108:].reshape(-1, cap, 4)[..., 3].sum()
    assert occupied == min(cap, 8) * n // 8
    np.testing.assert_allclose(got[..., :108], want[..., :108], rtol=1e-5,
                               atol=1e-6 * np.abs(want[..., :108]).max())
    assert np.abs(want[..., :54]).max() > 0.5


def _check_plain_gather(jproto):
    """tile_gather's plain version against make_gather_kernel in interpret
    mode on the JAX gather check's scene less 100 particles (so that the
    last chunk holds pad lanes), columns from a numpy seed: equal, the pad
    lanes' rows zero."""
    n, dx, shape, (payload, _, spans), _ = _sorted_both(jproto, *SCENES[1],
                                                        keep=-100)
    n_blocks = tproto.n_blocks_of(shape)
    n_chunks = spans.shape[0]
    cols = np.random.default_rng(3).standard_normal(
        (n_blocks, tproto.W, 128)).astype(np.float32)
    lanes = payload[:, :n_chunks * tproto.C]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jproto.make_gather_kernel(n_blocks, n_chunks, 128)(
            jnp.asarray(spans), jnp.asarray(lanes), jnp.asarray(cols)))
    got = tproto.make_gather_kernel(n_blocks, n_chunks, 128)(
        torch.from_numpy(spans), torch.from_numpy(lanes),
        torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(got, want)
    assert n % tproto.C and not got[n:].any()


def test_sort_scatter_and_gather_match_jax(jproto):
    """sort_particles on the three SCENES, the plain scatter at caps 4 and
    16, and the plain gather, against the JAX script's functions."""
    for scene in SCENES:
        _check_sort_particles(jproto, scene)
    for cap in (4, 16):
        _check_plain_scatter(jproto, cap)
    _check_plain_gather(jproto)


def test_checks_and_baselines_on_cpu():
    """The module's own checks pass with the plain versions, and its run
    reports every time at 16^3; the two baselines compute what they
    replace: the column tables hold the slot table's positions and the row
    gather the stacked columns at each key."""
    quiet = dict(log=lambda line: None)
    assert tproto.check_scatter_correctness(16, "cpu", **quiet)
    assert tproto.check_gather_correctness(16, 128, "cpu", **quiet)
    result = tproto.run("cpu", 16, batch_ms=1.0, **quiet)
    assert result["ok"] and result["particles"] == 16 * 4 * 16 * 8
    for key in ("sort_ms", "scatter_ms", "gather_ms", "column_scatters_ms",
                "row_gather_ms"):
        assert result[key] > 0, key
    pos, vel, dx, shape = tproto.make_scene(16)
    payload, starts, _ = tproto.sort_particles(
        torch.from_numpy(pos), torch.from_numpy(vel), dx, shape)
    n, n_cells = pos.shape[0], 16 ** 3
    cols = tproto.column_scatters(payload, n, n_cells, 16)
    table = tproto.tile_scatter_ref(starts, payload, tproto.tile_counts(
        shape), dx, 16)[..., 108:].reshape(n_cells, 16, 4)
    for f in range(3):
        assert torch.equal(cols[f].reshape(16, n_cells).t(), table[..., f])
    stacked = torch.randn((n_cells, 54))
    assert torch.equal(tproto.row_gather(payload, n, stacked),
                       stacked[payload[6, :n].long()])


def test_module_runs_from_the_command_line_without_jax():
    """python -m flipviscosity3d_torch.scripts.pallas_particle_proto
    --device cpu --res 16 exits 0 in a process where jax cannot be
    imported, its last line the result as JSON; without --device it asks
    for the card and fails here."""
    module = "pallas_particle_proto"
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            f"sys.argv = ['{module}', '--res', '16'] + sys.argv[1:]; "
            f"runpy.run_module('flipviscosity3d_torch.scripts.{module}', "
            "run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code, "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["check"] == module and last["card"] == "cpu"
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
