"""The reference's stand-in for the program's kernel library.

Every kernel wrapper of the copied modules asks `on_cpu` whether to take its
plain PyTorch version; here the answer is always yes, on any device, so the
reference never loads or launches a hand-written kernel. `slabs` is how
many runs of particles the plain scatters take one after the other, so
that their (particles, 54) temporaries fit beside the state at 256^3.
"""

import ctypes

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def on_cpu(t, name: str) -> bool:
    return True


# particles a plain scatter takes at once
SLAB_ROWS = 1 << 21


def slabs(pos) -> int:
    return max(1, -(-pos.shape[0] // SLAB_ROWS))


def _no_kernels(*args, **kwargs):
    raise RuntimeError("the reference launches no hand-written kernel")


require = launch = count = _no_kernels
