"""FluidSimulation: the public engine API of the port.

Mirrors flipviscosity3d_tpu/core/sim.py (reference fluidsimulation.h:53-63):
initialize / add_boundary / add_liquid / set_viscosity / set_gravity /
advance, plus particle positions. Every tensor lives on the
`device` given at construction.

Seeding cannot agree bitwise with the JAX package, which draws its jitter
with jax.random: here the same np.random.default_rng(0) draw seeds a
torch.Generator instead, so the particle count of a scene is close to the
JAX one but not equal. Tests feed both packages one state through
core.state.state_from_numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..io.trianglemesh import TriangleMesh, box_mesh
from ..ops import interp
from ..ops.mesh_sdf import MeshLevelSet, mesh_to_sdf
from ..solvers.viscosity import compute_face_states
from . import step as step_mod
from .state import SimState, SolidBoundary, StepDiagnostics

_SEED_BLOCK = 4_194_304   # candidate positions generated per block


class FluidSimulation:
    """Host-side owner of a SimState on `device`."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.cfg: SimConfig | None = None
        self._solid_sdf: MeshLevelSet | None = None
        self._particles_pos: list[torch.Tensor] = []
        self._state: SimState | None = None
        self._viscosity: torch.Tensor | None = None
        self._gravity = np.array([0.0, -9.81, 0.0], np.float32)
        self._rng = np.random.default_rng(0)
        self.last_diagnostics: StepDiagnostics | None = None

    # ---------------- setup API ----------------

    def initialize(self, isize: int, jsize: int, ksize: int, dx: float,
                   **cfg_overrides):
        """(fluidsimulation.cpp:26-43)"""
        self.cfg = SimConfig(isize=isize, jsize=jsize, ksize=ksize,
                             dx=float(dx), **cfg_overrides)
        self._viscosity = torch.ones(self.cfg.node_shape, dtype=torch.float32,
                                     device=self.device)
        self._initialize_boundary()

    def _mesh_sdf(self, mesh: TriangleMesh) -> MeshLevelSet:
        return mesh_to_sdf(mesh.vertices, mesh.triangles, self.cfg.grid_shape,
                           self.cfg.dx, self.device)

    def _domain_boundary_sdf(self) -> MeshLevelSet:
        """The negated SDF of the domain box inset by 1.5dx + 5e-7 per side
        (fluidsimulation.cpp:225-239, aabb.cpp:118-124)."""
        cfg = self.cfg
        inset = 0.5 * (3.0 * cfg.dx + 1e-6)
        pmax = (cfg.isize * cfg.dx - inset, cfg.jsize * cfg.dx - inset,
                cfg.ksize * cfg.dx - inset)
        return self._mesh_sdf(box_mesh((inset,) * 3, pmax)).negate()

    def _initialize_boundary(self):
        self._solid_sdf = self._domain_boundary_sdf()
        self._state = None

    def add_boundary(self, mesh: TriangleMesh, inverted: bool = False):
        """Union a solid obstacle (or inverted container) into the boundary
        SDF (fluidsimulation.cpp:45-58)."""
        self._assert_in_domain(mesh)
        sdf = self._mesh_sdf(mesh)
        if inverted:
            sdf = sdf.negate()
        self._solid_sdf = self._solid_sdf.union(sdf)
        self._state = None

    def _assert_in_domain(self, mesh: TriangleMesh):
        cfg = self.cfg
        lo, hi = mesh.aabb()
        dom_hi = np.array(
            [cfg.isize * cfg.dx, cfg.jsize * cfg.dx, cfg.ksize * cfg.dx])
        if (lo < 0).any() or (hi >= dom_hi).any():
            raise ValueError("mesh extends outside the simulation domain")

    def add_liquid(self, mesh: TriangleMesh):
        """Seed particles_per_cell jittered particles per cell inside the
        mesh SDF and outside solids (fluidsimulation.cpp:64-97), on the
        device, in blocks of candidates."""
        cfg = self.cfg
        self._assert_in_domain(mesh)
        mesh_phi = self._mesh_sdf(mesh).phi
        solid_phi = self._solid_sdf.phi
        ppc = cfg.particles_per_cell
        total = cfg.n_cells * ppc
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._rng.integers(0, 2**31 - 1)))
        kept = []
        for lo in range(0, total, _SEED_BLOCK):
            q = torch.arange(lo, min(lo + _SEED_BLOCK, total),
                             device=self.device)
            cell = q // ppc
            base = torch.stack(
                [cell // (cfg.jsize * cfg.ksize),
                 (cell // cfg.ksize) % cfg.jsize,
                 cell % cfg.ksize], dim=-1).to(torch.float32)
            jitter = torch.rand((q.shape[0], 3), generator=gen,
                                device=self.device) * cfg.dx
            p = base * cfg.dx + jitter
            keep = ((interp.trilinear(mesh_phi, p, cfg.dx) < 0)
                    & (interp.trilinear(solid_phi, p, cfg.dx) >= 0))
            kept.append(p[keep])
        self._particles_pos.append(torch.cat(kept))
        self._state = None

    def set_viscosity(self, value):
        """Uniform scalar or full (I+1,J+1,K+1) node grid
        (fluidsimulation.cpp:99-124)."""
        cfg = self.cfg
        value = np.asarray(value, np.float32)
        if (value < 0).any():
            raise ValueError("viscosity must be non-negative")
        if value.ndim == 0:
            visc = torch.full(cfg.node_shape, float(value),
                              dtype=torch.float32, device=self.device)
        elif value.shape == cfg.node_shape:
            visc = torch.from_numpy(value).to(self.device)
        else:
            raise ValueError(f"viscosity grid must have shape {cfg.node_shape}")
        self._viscosity = visc
        if self._state is not None:
            self._state = self._state.replace(viscosity=visc)

    def set_gravity(self, gx, gy, gz):
        """(fluidsimulation.cpp:126-132)"""
        self._gravity = np.array([gx, gy, gz], np.float32)
        if self._state is not None:
            self._state = self._state.replace(gravity=self._gravity_tensor())

    def _gravity_tensor(self):
        return torch.from_numpy(self._gravity.copy()).to(self.device)

    # ---------------- state assembly ----------------

    def _build_solid_boundary(self) -> SolidBoundary:
        sdf = self._solid_sdf
        center_phi = sdf.cell_center_phi()
        states = compute_face_states(center_phi, self.cfg)
        return SolidBoundary(
            phi=sdf.phi,
            center_phi=center_phi,
            weight_u=torch.clamp(1.0 - sdf.face_weight_u(), 0.0, 1.0),
            weight_v=torch.clamp(1.0 - sdf.face_weight_v(), 0.0, 1.0),
            weight_w=torch.clamp(1.0 - sdf.face_weight_w(), 0.0, 1.0),
            solid_u=states.solid_u,
            solid_v=states.solid_v,
            solid_w=states.solid_w,
        )

    @property
    def state(self) -> SimState:
        if self._state is None:
            cfg = self.cfg
            if self._particles_pos:
                pos = torch.cat(self._particles_pos)
            else:
                pos = torch.zeros((0, 3), dtype=torch.float32,
                                  device=self.device)
            self._state = SimState(
                pos=pos,
                vel=torch.zeros_like(pos),
                u=torch.zeros(cfg.u_shape, device=self.device),
                v=torch.zeros(cfg.v_shape, device=self.device),
                w=torch.zeros(cfg.w_shape, device=self.device),
                solid=self._build_solid_boundary(),
                viscosity=self._viscosity,
                gravity=self._gravity_tensor(),
            )
        return self._state

    # ---------------- simulation ----------------

    def advance(self, dt: float) -> StepDiagnostics:
        """Advance one frame with CFL substeps (fluidsimulation.cpp:135-168)."""
        state = self.state
        if state.pos.shape[0] == 0:
            raise RuntimeError("no liquid particles; call add_liquid first")
        self._state, diag = step_mod.advance(state, float(dt), self.cfg)
        self.last_diagnostics = diag
        if self.cfg.on_bucket_overflow == "error" and diag.bucket_overflow:
            raise RuntimeError(
                f"bucket overflow: {diag.bucket_overflow} particles exceeded "
                f"the SDF table capacity {self.cfg.sdf_cap}; raise "
                "bucket_capacity or accept on_bucket_overflow='fallback'")
        return diag

    @property
    def particle_positions(self) -> np.ndarray:
        return self.state.pos.cpu().numpy()
