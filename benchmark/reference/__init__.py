"""The plain reference of the benchmark: a frozen copy of the FLIP step's
plain PyTorch path, independent of the package it judges.

The modules under config.py, core/, ops/, solvers/ and io/ are copies of
the port's modules at commit 169a842 (flipviscosity3d_torch/), unchanged
but for this package's `_build`, which makes every kernel wrapper take its
plain PyTorch version on any device, and the two P2G scatter wrappers of
ops/pallas_particles.py, which hand their plain version `_build.slabs`
runs of particles (the plain version's own option) so that it fits on
the card at 256^3. So the reference builds the scene
from the same seed and computes a "pallas" substep the way the port's
CPU path does: every scatter, gather and V-cycle level in plain torch
operations, in float32. Nothing here imports the port or JAX.
"""

import torch

# the multigrid coarse solve is a float32 matmul: no TF32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
