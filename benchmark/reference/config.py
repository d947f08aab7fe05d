"""Simulation configuration for the PyTorch / CUDA port.

Every physics and solver field of flipviscosity3d_tpu.config.SimConfig is
kept here with the same name and default, so that one scene description
drives both packages the same way. particle_engine picks one of the JAX
package's three particle engines, with its values and its default:

- "table" (the default): per pass, a stable sort by i-major home cell and
  fixed-capacity (bucket_capacity, n_cells) slot tables; every transfer is
  a dense per-slot reduction or sample (ops/buckets.py,
  ops/particle_grid.py). Pass A buckets by position, pass B by RK2
  midpoint; a particle beyond its cell's capacity in a pass skips that
  pass's grid transfer and moves ballistically (counted in
  bucket_overflow). Particles leave a substep in table B's sorted order.
  sdf_capacity does not apply.
- "stream": one stable sort per substep; P2G sums and SDF mins as segment
  reductions over the sorted stream, samples as row gathers of per-cell
  columns (ops/stream.py, ops/stream_transfers.py). No capacity, no
  overflow. Particles leave a substep in pass A's stream order.
- "pallas": the tile-major engine of ops/pallas_particles.py, whose
  scatters and gathers are the CUDA kernels of csrc/. Its grid must tile
  into 8x8x8 blocks; the SDF slot table holds sdf_capacity particles per
  cell (None: bucket_capacity). Its three visit-plan switches are fields
  here with the JAX names, defaults and value sets:
  - pallas_pass_a: "sort" re-sorts the particles by tile-major home-cell
    key every substep; "stale" keeps the previous substep's order,
    re-sorts only every pallas_resort_every substeps (and on the first
    substep of every frame), and computes the in-cell ranks inside the
    scatter kernel; particles beyond their chunk's pallas_passa_budget
    distinct tiles skip the substep's grid transfers (counted in
    bucket_overflow);
  - pallas_pass_b: "plan" (the default) samples the RK2 midpoints in
    pass-A order through a midpoint visit plan and advects uncovered
    midpoints ballistically (counted); "sort" re-sorts by midpoint key and
    samples every midpoint;
  - pallas_pushback: "gather" reads the node SDF corners of every
    particle; "kernel" reads them through a visit plan, and uncovered
    particles skip the pushback for one substep (counted).

The "table" and "stream" engines were plain XLA in the JAX package and are
plain PyTorch here; their V-cycles run through the mg_down / mg_up kernels
on the card like the "pallas" engine's.

pallas_split_gather (True, False or None) is taken so that one scene
file's `config` block serves both packages' CLIs, and changes nothing: in
the JAX package it halves the lane width of pass A's gather image (two
launches of one grid each instead of one of two), a choice of memory
layout. The port's gather reads the velocity grids directly and has no
image, so two launches would give the same samples bit for bit while
reading the positions and keys twice: pass A always gathers both grids in
one launch.

fold_sums (the K-folded sums of the scatter at >= 2^24 cells) is no field
here, as it is none in the JAX package: the scatter decides by the grid
size itself (ops/pallas_particles.py).

pallas_gather_dtype ("f32", the default, or "bf16") is a field because it
changes what the "pallas" engine's step computes: under "bf16" the JAX
step stores the column image that G2P and the midpoint sample read in
bf16, so every sample is taken from grid values rounded to bf16 (round to
nearest even) before the f32 trilinear combine. The port's gather reads
the velocity grids directly, so under "bf16" the step rounds the six grids
that way before its two gathers (core/step.py); the grids kept in the
state stay f32. Any other value raises.

mg_backend ("auto", the default, "xla" or "pallas") chooses the V-cycle's
executor in the JAX package; the port has one executor for the V(1,1)
cycle, the mg_down / mg_up kernels on the card (their plain PyTorch
versions on the CPU), and takes the field for what it changes in what is
computed: the storage type of the level operators on the card
(solvers/multigrid.py). "xla" stores them in f32 whatever
mg_operator_dtype says, as the JAX package's XLA cycle keeps f32 levels;
"auto" stores mg_operator_dtype where the fine level's j*k plane is at
most 260*260 and f32 above, where the JAX package leaves its fused
kernels for the XLA cycle; "pallas" stores mg_operator_dtype and, as in
the JAX package, raises a ValueError for smoothing other than V(1,1),
which the fused kernels do not implement.

pallas_split_terms (an int, default 3) is the number of bf16 terms of the
JAX package's one-hot MXU products. At 1 and 2 the JAX package rounds the
value operand of its scatter and MAC-gather products, on the CPU as on the
TPU, and so does the port: each value x is cut into bf16(x) and, at 2,
bf16(x - bf16(x)) (round to nearest even); the P2G scatters (K1, K5) sum
each term over a cell's particles on its own and add the sums at the end,
and their slot tables hold the rounded positions; the MAC gathers (K2)
weight the rounded face values. Any other value keeps the exact f32
products: what the JAX package computes at >= 3 off the TPU (its <= 0 is a
three-term split, within 2^-22 of them).
"""

from __future__ import annotations

import dataclasses
import math

PARTICLE_ENGINES = ("table", "stream", "pallas")

_ENUMS = {
    "on_bucket_overflow": ("fallback", "error"),
    "mg_operator_dtype": ("bf16", "f32"),
    "viscosity_preconditioner": ("jacobi", "multigrid"),
    "pressure_preconditioner": ("jacobi", "multigrid"),
    "pallas_pass_a": ("sort", "stale"),
    "pallas_pass_b": ("plan", "sort"),
    "pallas_pushback": ("gather", "kernel"),
    "pallas_gather_dtype": ("f32", "bf16"),
    "mg_backend": ("auto", "xla", "pallas"),
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

    # The particle engine: "table", "stream" or "pallas" (module docstring).
    particle_engine: str = "table"

    # "table": particles tracked per cell in each pass's slot tables; a
    # particle of in-cell rank >= capacity skips that pass's transfer.
    # "pallas": the liquid-SDF slot table's capacity unless sdf_capacity is
    # set; its P2G sums take every particle, and particles of rank >=
    # capacity are left out of the SDF table only. Either way the particles
    # left out are counted in bucket_overflow. "stream" has no capacity.
    bucket_capacity: int = 24
    # The "pallas" engine's liquid-SDF table capacity; None ->
    # bucket_capacity. The "table" engine ignores it.
    sdf_capacity: int | None = None
    # "error" makes FluidSimulation.advance raise when a frame reports
    # bucket_overflow > 0; "fallback" accepts it.
    on_bucket_overflow: str = "fallback"

    # Storage dtype of the V-cycle level operators on the card ("bf16" or
    # "f32") where mg_backend keeps it; arithmetic is f32 either way. The
    # CPU path always stores f32, as the JAX package's CPU path does.
    mg_operator_dtype: str = "bf16"

    # Visit-plan variants of the particle engine (module docstring). A
    # budget is the number of distinct tiles a chunk of 512 particles may
    # touch; a factor times the chunk count caps the plan's visits once
    # budget * chunks exceeds 8192.
    pallas_pass_a: str = "sort"
    pallas_resort_every: int = 8
    pallas_passa_budget: int = 8
    pallas_passa_factor: float = 3.0
    pallas_pass_b: str = "plan"
    pallas_midpoint_budget: int = 8
    pallas_midpoint_factor: float = 3.0
    pallas_pushback: str = "gather"
    # Taken for the JAX package's scene files; no effect (module docstring).
    pallas_split_gather: bool | None = None
    # "bf16": G2P and the midpoint sample read grid values rounded to bf16
    # (module docstring).
    pallas_gather_dtype: str = "f32"
    # bf16 terms of the particle kernels' products: 1 and 2 round them as
    # the JAX package does, any other value is exact (module docstring).
    pallas_split_terms: int = 3

    max_substeps: int = 64

    viscosity_preconditioner: str = "multigrid"
    pressure_preconditioner: str = "multigrid"

    mg_max_levels: int = 16
    mg_coarse_size: int = 8
    mg_pre_smooth: int = 1
    mg_post_smooth: int = 1
    mg_omega: float = 0.8
    mg_coarse_scale: float = 1.4
    # "auto", "xla" or "pallas": the V-cycle operators' storage on the card
    # (module docstring).
    mg_backend: str = "auto"

    def __post_init__(self):
        if self.particle_engine not in PARTICLE_ENGINES:
            raise ValueError(
                f"particle_engine must be one of {PARTICLE_ENGINES}, got "
                f"{self.particle_engine!r}")
        for name, allowed in _ENUMS.items():
            if getattr(self, name) not in allowed:
                raise ValueError(
                    f"{name} must be one of {allowed}, got "
                    f"{getattr(self, name)!r}")
        for name in ("pallas_resort_every", "pallas_passa_budget",
                     "pallas_midpoint_budget"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
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
