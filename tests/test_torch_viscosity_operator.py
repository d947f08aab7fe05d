"""K13's wrapper, the coupled viscosity operator, on the CPU: for CPU
tensors it is the plain version (_apply_coupling, then diag * x), at the
solve's face shapes, an odd grid and a slab's halo'd shapes; smoke's
record of it runs on CPU tensors; the planes a block marches through. The
kernel itself is held against the plain version on the card
(tests/test_torch_gpu.py)."""

import pytest
import torch

from flipviscosity3d_torch import smoke
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.solvers import viscosity as vs


def _faces(i, j, k):
    return ((i + 1, j, k), (i, j + 1, k), (i, j, k + 1))


# a cube, an odd grid, and slab shapes as the slab pipeline hands them
# (B + 2H = 20 rows of a 16^3 grid in 2 slabs, on every component)
SHAPES = {"cube": _faces(8, 8, 8), "odd": _faces(13, 18, 11),
          "slab": ((20, 16, 16), (20, 17, 16), (20, 16, 17))}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(SHAPES))
def test_wrapper_on_cpu_is_the_plain_operator(name):
    gen = torch.Generator()
    gen.manual_seed(1)
    factors, diag, x = smoke.random_viscosity_operator(SHAPES[name], gen,
                                                       "cpu")
    coupling = vs._apply_coupling(factors, *x)
    got = vs.viscosity_operator(factors, x)
    assert all(torch.equal(g, c) for g, c in zip(got, coupling))
    full = vs.viscosity_operator(factors, x, diag)
    for g, d, xi, c in zip(full, diag, x, coupling):
        assert torch.equal(g, d * xi + c)
    system = vs.ViscositySystem(in_mat=None, diag=diag, vol=None,
                                factors=factors, rhs=None)
    assert all(torch.equal(a, b) for a, b in zip(
        vs.apply_viscosity_matrix(system, list(x)), full))
    assert vs.viscosity_operator.launches == 0


def test_wrapper_refuses_a_device_it_does_not_serve():
    factors, diag, x = smoke.random_viscosity_operator(
        SHAPES["cube"], torch.Generator(), "cpu")
    with pytest.raises(ValueError):
        vs.viscosity_operator(factors, tuple(t.to("meta") for t in x), diag)


def test_operator_record_runs_on_cpu():
    """smoke's K13 record, which chip_smoke.py runs on the card at 128^3
    and 256^3, at 16^3 on CPU tensors: both checks equal, the bound that of
    27 grids read or written once."""
    cfg = SimConfig(isize=16, jsize=16, ksize=16, dx=1.0 / 16)
    gen = torch.Generator()
    gen.manual_seed(0)
    checks, times, bnd = smoke._viscosity_operator_record(
        cfg, torch.device("cpu"), gen)
    assert [c["check"] for c in checks] == ["diag * x + C(x)", "C(x)"]
    assert all(c["ok"] for c in checks)
    assert bnd["bytes"] == 9 * 4 * 3 * 17 * 16 * 16
    assert bnd["bound_by"] == "bytes"
    assert times["ms"] > 0 and times["ms_cold"] is None


def test_plane_chunk_fills_the_card():
    """Eight waves of 4 blocks an SM on 132 SMs where the planes allow it,
    at least 4 planes a block."""
    assert vs.plane_chunk((129, 129, 129), 132) == 4
    assert vs.plane_chunk((257, 257, 257), 132) == 18
    assert vs.plane_chunk((13, 19, 12), 132) == 4
