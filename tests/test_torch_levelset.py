"""The port's area fractions (ops/levelset.area_fraction_triangle,
area_fraction_quad) against the JAX package's, on the CPU: random corners
of every sign pattern within rtol 1e-6, and the reference's all-inside
triangle, which both packages answer with 0 (tests/test_levelset.py:186-
190 holds the JAX package to it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipviscosity3d_torch.ops import levelset as tls
from flipviscosity3d_tpu.ops import levelset as jls


def _corners(k, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, 4096)).astype(np.float32)
    c[:, :64] = np.sign(c[:, :64])          # equal magnitudes
    c[:, 64:96] = 0.0                       # on the surface
    return c


@pytest.mark.parametrize("name, k", [("area_fraction_triangle", 3),
                                     ("area_fraction_quad", 4)])
def test_area_fractions_match_jax(name, k):
    c = _corners(k, k)
    got = getattr(tls, name)(*torch.from_numpy(c)).numpy()
    want = np.asarray(getattr(jls, name)(*jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_all_inside_triangle_is_what_jax_answers():
    for corners in ((-1.0, -1.0, -1.0), (-1.0, 1.0, 1.0), (1.0, 1.0, 1.0)):
        assert float(tls.area_fraction_triangle(*corners)) == float(
            jls.area_fraction_triangle(*corners))
    assert float(tls.area_fraction_quad(-1.0, -1.0, -1.0, -1.0)) == float(
        jls.area_fraction_quad(-1.0, -1.0, -1.0, -1.0))
