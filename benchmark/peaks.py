"""The yardstick's fixed numbers: the card's data-sheet peaks and the bytes
that the V-cycle kernels K3 (mg_down) and K4 (mg_up) must move.

The bytes are counted from the level shapes of a grid, each input read once
and each output written once, whatever the kernels read again: the rule of
flipviscosity3d_torch.smoke._vcycle_records, frozen here with the
hierarchy's coarsening rule (solvers/multigrid.build_hierarchy) and the
level operators' storage type on the card (multigrid._storage_dtype) as
they stood at commit 169a842.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense, 700 W): HBM3 bytes/s and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the JAX package's largest fine j*k plane for its fused V-cycle, above
# which the levels are stored in f32 (multigrid._FUSED_MAX_PLANE)
_FUSED_MAX_PLANE = 260 * 260


def coarse_shape(shape):
    nb, i, j, k = shape
    return (nb, (i + 1) // 2, (j + 1) // 2, (k + 1) // 2)


def level_shapes(grid, sim_config: dict) -> dict:
    """The (nb, I, J, K) shapes of the levels above the coarsest (the ones
    K3 / K4 run on) of both solves' hierarchies: "pressure" from (1, I, J,
    K), "viscosity" from (3, I+1, J+1, K+1)."""
    max_levels = sim_config.get("mg_max_levels", 16)
    coarse = sim_config.get("mg_coarse_size", 8)
    out = {}
    for label, fine in (("pressure", (1,) + tuple(grid)),
                        ("viscosity", (3,) + tuple(s + 1 for s in grid))):
        levels = [fine]
        while len(levels) < max_levels and min(levels[-1][1:]) > coarse:
            levels.append(coarse_shape(levels[-1]))
        out[label] = levels[:-1]
    return out


def operator_bytes(fine, sim_config: dict) -> int:
    """Bytes an element of a level operator takes on the card."""
    if sim_config.get("mg_operator_dtype", "bf16") == "f32":
        return 4
    backend = sim_config.get("mg_backend", "auto")
    if backend == "xla" or (backend == "auto"
                            and fine[-2] * fine[-1] > _FUSED_MAX_PLANE):
        return 4
    return 2


def vcycle_bytes(grid, sim_config: dict) -> dict:
    """Bytes one V(1,1) cycle's K3 and K4 launches must move, per solve:
    K3 reads the operator (diag and three links), b, and writes x and the
    coarse residual; K4 reads the operator, b, x and the coarse correction
    and writes the result. f32 vectors, operators in their storage type."""
    if (sim_config.get("mg_pre_smooth", 1),
            sim_config.get("mg_post_smooth", 1)) != (1, 1):
        return {"pressure": 0, "viscosity": 0}
    out = {}
    for label, shapes in level_shapes(grid, sim_config).items():
        op = operator_bytes(shapes[0], sim_config)
        total = 0
        for s in shapes:
            n = s[0] * s[1] * s[2] * s[3]
            c = coarse_shape(s)
            nc = c[0] * c[1] * c[2] * c[3]
            total += 4 * n * op + 2 * n * 4 + nc * 4          # K3
            total += 4 * n * op + 3 * n * 4 + nc * 4          # K4
        out[label] = total
    return out


def vcycle_launches(grid, sim_config: dict) -> dict:
    """K3 (and K4) launches of one V-cycle, per solve."""
    return {k: len(v) for k, v in level_shapes(grid, sim_config).items()}
