"""The honey coil (the benchmark's honey128 configuration under its visc20
traffic) cut to 32^3, the port against the benchmark's plain reference
(benchmark/reference/), on the CPU.

The scene keeps honey128's unit-domain geometry (an inverted icosphere of
radius 0.47 about the centre, a rod along y standing on its floor) except
the rod's radius, 0.08 (2.6 cells) in place of 0.04, and the icosphere's
subdivisions, 3 in place of 5. The port builds it from a seed and runs 2
frames of advance; every substep is rerun through the reference's step
from the port's state before it, as the benchmark's output check does
(benchmark/check.py::judge): the same dt, positions, velocities and grids
within honey128's limits, and the viscosity solve's iterations within 1
and its converged outcome the same. The reference takes the solid's fields
from the port's state, so that the icosphere's brute-force SDF, most of
the set-up, is computed once; the benchmark's check builds them itself
and holds them equal (start_gap 0) in every run on the card.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from benchmark import check, scene
from benchmark.reference.config import SimConfig as RefConfig
from benchmark.reference.core import state as ref_state
from benchmark.reference.core import step as ref_step
from flipviscosity3d_torch.core import step as tstep
from flipviscosity3d_torch.core.state import state_to_numpy

RES = 32
SEED = 3141592653
FRAMES = 2
DYNAMIC = ("pos", "vel", "u", "v", "w")


def _copy(state):
    return state.replace(**{f: getattr(state, f).clone() for f in DYNAMIC})


def _spec() -> dict:
    spec = scene.load_spec("honey128", "visc20")
    spec["resolution"] = RES
    del spec["dx"]
    spec["boundary"][0]["subdivisions"] = 3
    spec["liquid"][0]["radius"] = 0.08
    return spec


@pytest.fixture(scope="module")
def honey():
    """The port's scene, the reference's configuration and static state,
    and the port's substeps of FRAMES frames as (frame, substep, time
    before it, dt, state in, state out, diagnostics)."""
    torch.set_num_threads(1)
    spec = _spec()
    sim = scene.build(scene.program(), spec, SEED, "cpu")
    start = sim.state
    ref_cfg = RefConfig(isize=RES, jsize=RES, ksize=RES, dx=1.0 / RES,
                        **spec["sim_config"])
    ref_static = ref_state.state_from_numpy(state_to_numpy(start), "cpu")
    substeps, real = [], tstep.step
    where = {"frame": 0, "t": np.float32(0.0)}

    def step(state, dt, cfg, substep_idx=None):
        out = real(state, dt, cfg, substep_idx=substep_idx)
        substeps.append((where["frame"], substep_idx or 0, where["t"], dt,
                         _copy(state), _copy(out[0]), out[1]))
        where["t"] = np.float32(where["t"] + np.float32(dt))
        return out

    diags = []
    with mock.patch.object(tstep, "step", step):
        for f in range(FRAMES):
            where["frame"], where["t"] = f, np.float32(0.0)
            diags.append(sim.advance(float(spec["frame_dt"])))
    return spec, sim.cfg, start, ref_static, ref_cfg, substeps, diags


def test_honey_scene_stands_a_rope_in_the_inverted_sphere(honey):
    """A rope of 2.6 cells' radius standing above the sphere's floor, at
    rest; the solid is the inside-out icosphere (solid at the domain's
    corners, open at its centre) and the reference's configuration is the
    port's."""
    _, cfg, start, _, ref_cfg, _, _ = honey
    n = start.pos.shape[0]
    assert 3000 < n < 4500, n
    assert float(start.pos[:, 1].min()) > 0.03   # above the sphere's floor
    assert float(start.vel.abs().max()) == 0.0
    phi = start.solid.center_phi
    assert float(phi[0, 0, 0]) < 0 < float(phi[RES // 2, RES // 2, RES // 2])
    assert ref_cfg == RefConfig(**vars(cfg))


def test_honey_substeps_agree_with_the_reference(honey):
    """Every substep of 2 frames rerun through the reference's step from
    the port's state before it: dt equal, the gaps within honey128's
    limits, the viscosity solve's iterations within 1 and its converged
    outcome the same; both solves ran on every substep."""
    spec, cfg, _, ref_static, ref_cfg, substeps, diags = honey
    limits = spec["limits"]
    assert sum(d.substeps for d in diags) == len(substeps) >= FRAMES
    assert sum(d.viscosity_solves for d in diags) == len(substeps)
    for frame, k, t_before, dt, state_in, got, d in substeps:
        ref_in = ref_static.replace(**{
            f: getattr(state_in, f) for f in DYNAMIC})
        want_dt = check.reference_dt(ref_step, ref_in, ref_cfg,
                                     float(spec["frame_dt"]), t_before)
        assert abs(dt - want_dt) / want_dt <= limits["dt_gap"]
        want, wd = ref_step.step(ref_in, want_dt, ref_cfg, substep_idx=k)
        gaps = {
            "pos_gap": float((got.pos - want.pos).abs().max()) / cfg.dx,
            "vel_gap": check._rel(got.vel, want.vel),
            "grid_gap": max(check._rel(getattr(got, c), getattr(want, c))
                            for c in ("u", "v", "w")),
        }
        for name, gap in gaps.items():
            assert gap <= limits[name], (frame, k, name, gap)
        assert abs(d["viscosity_iterations"]
                   - wd["viscosity_iterations"]) <= 1, (frame, k)
        assert d["viscosity_iterations"] > 0
        ref_converged = float(wd["viscosity_residual"]) <= float(
            wd["viscosity_tolerance"])
        assert (not d["viscosity_unconverged"]) == ref_converged, (frame, k)
        assert d["viscosity_solves"] == 1


def test_honey_viscosity_solves_are_counted(honey):
    """The frames' counters: one viscosity solve a substep; each solve the
    frame counts as unconverged is one whose substep says so."""
    _, _, _, _, _, substeps, diags = honey
    for f, d in enumerate(diags):
        mine = [s[6] for s in substeps if s[0] == f]
        assert d.viscosity_solves == d.substeps == len(mine)
        assert d.viscosity_unconverged == sum(
            m["viscosity_unconverged"] for m in mine)
        assert d.viscosity_iterations == sum(
            m["viscosity_iterations"] for m in mine)
