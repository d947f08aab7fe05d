"""Simulation configuration for the PyTorch / CUDA port.

Every physics and solver field of flipviscosity3d_tpu.config.SimConfig is
kept here with the same name and default, so that one scene description
drives both packages. The TPU-only knobs of that class are not fields here:
the particle engine choice, the Pallas pass-A / pass-B / pushback variants,
their visit-plan budgets, the bf16 split terms, the gather column layout and
dtype, and the V-cycle backend. The port implements exactly one variant of
each, which in the JAX package's terms is

- pass A = "sort": particles are re-sorted by tile-major home-cell key every
  substep;
- pass B = "sort": every RK2 midpoint is sampled directly, with no visit plan,
  no ballistic fallback and no pass-B overflow;
- pushback = "gather": one row gather of the node SDF per particle;
- the V(1,1) V-cycle runs through the mg_down / mg_up kernels on the card and
  through their plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

_ENUMS = {
    "on_bucket_overflow": ("fallback", "error"),
    "mg_operator_dtype": ("bf16", "f32"),
    "viscosity_preconditioner": ("jacobi", "multigrid"),
    "pressure_preconditioner": ("jacobi", "multigrid"),
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All numerical constants of the FLIP solver (defaults reproduce the
    reference's hardcoded values; see the JAX package's config for the
    per-field provenance)."""

    isize: int = 64
    jsize: int = 64
    ksize: int = 64
    dx: float = 1.0 / 64.0

    cfl_number: float = 5.0
    ratio_pic_flip: float = 0.05
    minfrac: float = 0.01
    mesh_levelset_exact_band: int = 3
    particle_radius_factor: float = 1.01 * (3.0 ** 0.5) / 2.0
    particles_per_cell: int = 8
    # None derives ceil(cfl_number) + 2 at construction.
    extrapolation_layers: int | None = None

    pressure_solve_max_iterations: int = 200
    pressure_solve_tolerance: float = 1e-9       # absolute floor
    pressure_solve_rtol: float = 1e-6            # relative to ||b||_inf

    viscosity_solve_max_iterations: int = 700
    viscosity_solve_rtol: float = 1e-6
    viscosity_acceptable_error: float = 10.0

    # Particles tracked per cell in the liquid-SDF slot table. The P2G sums
    # take every particle; particles of in-cell rank >= capacity are left out
    # of the SDF table only, and counted in bucket_overflow.
    bucket_capacity: int = 24
    # Liquid-SDF table capacity; None -> bucket_capacity.
    sdf_capacity: int | None = None
    # "error" makes FluidSimulation.advance raise when a frame reports
    # bucket_overflow > 0; "fallback" accepts it.
    on_bucket_overflow: str = "fallback"

    # Storage dtype of the V-cycle level operators on the card ("bf16" or
    # "f32"); arithmetic is f32 either way. The CPU path always stores f32,
    # as the JAX package's CPU path does.
    mg_operator_dtype: str = "bf16"

    max_substeps: int = 64

    viscosity_preconditioner: str = "multigrid"
    pressure_preconditioner: str = "multigrid"

    mg_max_levels: int = 16
    mg_coarse_size: int = 8
    mg_pre_smooth: int = 1
    mg_post_smooth: int = 1
    mg_omega: float = 0.8
    mg_coarse_scale: float = 1.4

    def __post_init__(self):
        for name, allowed in _ENUMS.items():
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"{name} must be one of {allowed}, got "
                    f"{getattr(self, name)!r}")
        if self.extrapolation_layers is None:
            object.__setattr__(
                self, "extrapolation_layers",
                int(math.ceil(self.cfl_number)) + 2,
            )

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return (self.isize, self.jsize, self.ksize)

    @property
    def n_cells(self) -> int:
        return self.isize * self.jsize * self.ksize

    @property
    def particle_radius(self) -> float:
        return self.dx * self.particle_radius_factor

    @property
    def sdf_cap(self) -> int:
        return self.sdf_capacity or self.bucket_capacity

    @property
    def u_shape(self) -> tuple[int, int, int]:
        return (self.isize + 1, self.jsize, self.ksize)

    @property
    def v_shape(self) -> tuple[int, int, int]:
        return (self.isize, self.jsize + 1, self.ksize)

    @property
    def w_shape(self) -> tuple[int, int, int]:
        return (self.isize, self.jsize, self.ksize + 1)

    @property
    def node_shape(self) -> tuple[int, int, int]:
        return (self.isize + 1, self.jsize + 1, self.ksize + 1)
