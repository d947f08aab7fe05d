"""flipviscosity3d_torch — the PyTorch / CUDA port of flipviscosity3d_tpu.

A FLIP liquid simulator with variational pressure and viscosity solves. The
particle transfers (P2G scatter, G2P gather) and the multigrid V-cycle levels
run as hand-written CUDA kernels for the H100 (csrc/, built on first use by
_build.py); everything else is plain PyTorch. On CPU tensors every kernel
wrapper takes its plain PyTorch version instead.

This package never imports JAX.
"""

import torch

# The coarse-level dense solve of the multigrid preconditioner is a float32
# matmul: it must not silently drop to TF32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import SimConfig  # noqa: E402
from .core.sim import FluidSimulation  # noqa: E402
from .core.state import SimState, StepDiagnostics  # noqa: E402

__all__ = ["FluidSimulation", "SimConfig", "SimState", "StepDiagnostics"]
