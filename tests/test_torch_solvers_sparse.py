"""A committed witness of the viscosity MG-PCG's stall on sparse liquid: the
port against the JAX package on one handed state, on the CPU.

The state is readiness256's scene cut to 32^3: particles uniform in
[2/32, 30/32] x [2/32, 0.25] x [2/32, 30/32] at 0.25 a cell of that box
(1,176 particles, default_rng(0)), at rest, viscosity 5, the analytic
inverted-box solid, handed to both packages as numpy arrays. Both
packages assemble the viscosity system of a dt = 0.004 substep (what
solver_microbench does) and solve it with MG-PCG and with Jacobi PCG
(precond_experiment's "multigrid" and "jacobi" modes).

What it shows: both packages' MG-PCG hit the 700-iteration cap with the
residual far above its tolerance, while Jacobi converges in 112 in both,
so MG-PCG needs more than six times Jacobi's iterations and never gets
there. The test holds the port to JAX (iterations within 1 per solve, the
same outcome) and the state to the witness (MG more than six times
Jacobi); it does not hold the stall itself as right. The stall is the reference's own behaviour, not the port's: the fine
and first coarse viscosity blocks have near-zero eigenvalues of D^-1 A on
sparse liquid, and the MG-preconditioned CG is then so fragile that a
rounding-level change decides it (the JAX package's solve converges in 56
when its system is assembled op by op and the solve is compiled whole,
and stalls at 700 in the three other combinations). JAX's system is
assembled under jit here, as its step assembles it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flipviscosity3d_tpu.solvers import viscosity as jvsolver
from flipviscosity3d_torch.config import SimConfig
from flipviscosity3d_torch.core.state import state_from_numpy, state_to_numpy
from flipviscosity3d_torch.scripts import readiness256, solver_microbench
from flipviscosity3d_torch.solvers import viscosity as tvsolver
from test_torch_scripts import _close, _jax_cfg, _jax_systems
from test_torch_step import _jax_state

RES = 32
DENSITY = 0.25
DT = 0.004


@pytest.fixture(scope="module")
def sparse_state():
    torch.set_num_threads(1)
    cfg = SimConfig(isize=RES, jsize=RES, ksize=RES, dx=1.0 / RES,
                    bucket_capacity=8)
    m = 2.0 / RES
    lo = np.array([m, m, m])
    hi = np.array([1.0 - m, 0.25, 1.0 - m])
    n = int(round(DENSITY * RES ** 3 * np.prod(hi - lo)))
    rng = np.random.default_rng(0)
    pos = (rng.uniform(size=(n, 3)) * (hi - lo) + lo).astype(np.float32)
    sim = readiness256.readiness_sim("cpu", cfg, 5.0, torch.from_numpy(pos))
    return cfg, state_to_numpy(sim.state)


def test_viscosity_mg_pcg_stalls_in_both_packages(sparse_state):
    torch.set_num_threads(1)
    cfg, arrays = sparse_state
    assert arrays["pos"].shape[0] == 1176
    tv, _, tuvw = solver_microbench.build_systems(
        state_from_numpy(arrays, "cpu"), cfg, dt=DT)
    jcfg = _jax_cfg(cfg)
    jv, _, juvw = jax.jit(lambda s: _jax_systems(s, jcfg, dt=DT))(
        _jax_state(arrays))
    for a in range(3):
        np.testing.assert_array_equal(tv.in_mat[a].numpy(),
                                      np.asarray(jv.in_mat[a]))
        _close(tv.rhs[a].numpy(), jv.rhs[a])
        _close(tv.diag[a].numpy(), jv.diag[a])

    got = {}
    for pre in ("multigrid", "jacobi"):
        c = dataclasses.replace(cfg, viscosity_preconditioner=pre)
        t = tvsolver.solve_viscosity(tv, c, warm_start=tuvw)
        jc = _jax_cfg(c)
        j = jax.jit(lambda s, w: jvsolver.solve_viscosity(
            s, jc, warm_start=w))(jv, juvw)
        got[pre] = (t, j)
        assert abs(t.iterations - int(j.iterations)) <= 1, (
            pre, t.iterations, int(j.iterations))

    jtol = cfg.viscosity_solve_rtol * max(float(np.abs(np.asarray(r)).max())
                                          for r in jv.rhs)
    t, j = got["jacobi"]
    assert t.converged and bool(j.converged)
    assert float(t.residual) <= float(t.tol)
    assert float(j.residual) <= jtol
    jacobi = int(j.iterations)
    t, j = got["multigrid"]
    # the witness: JAX's MG-PCG takes more than six times Jacobi's
    # iterations (700, the cap, against 112 when this was written) and
    # the port does the same; a repair of the stall in both packages
    # changes these two lines, not the parity above
    assert int(j.iterations) > 6 * jacobi
    assert t.converged == bool(j.converged)
    if not t.converged:
        assert float(t.residual) > float(t.tol)
        assert float(j.residual) > jtol
