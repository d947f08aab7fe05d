"""The two fused V-cycle level kernels, DOWN and UP, and their plain versions.

Counterpart of flipviscosity3d_tpu/ops/pallas_mg.py (`down` / `up`). One
level of a V(1,1) cycle is two launches:

- DOWN: pre-smooth from zero x = omega*D^-1 b, residual r = b - A x, and
  the 2x2x2 sum-pool of r (the restriction);
- UP: x2 = x + scale*P(xc) with piecewise-constant prolongation P, then one
  damped-Jacobi sweep x2 + omega*D^-1 (b - A x2).

A x = diag*x - sum_ax (L_ax*x(+ax) + (L_ax*x)(-ax)), zero out of range, as in
solvers/multigrid.py. Arrays are (nb, I, J, K) at the level's real shape; the
operator (diag and three links) is f32 or bf16, b, x and all arithmetic f32.

`mg_down` / `mg_up` take the plain PyTorch version for CPU tensors and
launch the CUDA kernel (csrc/mg_vcycle.cu) for CUDA tensors; there is no
fallback between the two. The kernels march blocks of 16 x 16 fine
columns along i through chunks of planes; `plane_chunk` sizes the chunks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .grids import shifted_read

_OPERATOR_DTYPES = (torch.float32, torch.bfloat16)


def inv_diag(d):
    """1/d where d > 0, else 0."""
    return torch.where(d > 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                       torch.zeros_like(d))


def apply_level(diag, links, x):
    """y = diag*x - sum_ax (L*x(+ax) + shifted(L*x)(-ax)) on the last three
    axes. Symmetric by construction."""
    spatial = x.shape[-3:]
    y = diag * x
    for ax in range(3):
        up = [0, 0, 0]
        up[ax] = 1
        dn = [0, 0, 0]
        dn[ax] = -1
        L = links[ax]
        y = y - L * shifted_read(x, tuple(up), spatial)
        y = y - shifted_read(L * x, tuple(dn), spatial)
    return y


def pool_sum(a):
    """2x2x2 sum pooling of the last three axes; an odd extent's last
    aggregate pools one row. Pairs are summed along i, then j, then k."""
    i, j, k = a.shape[-3:]
    a = F.pad(a, (0, k % 2, 0, j % 2, 0, i % 2))
    lead = a.shape[:-3]
    i, j, k = a.shape[-3:]
    a = a.reshape(lead + (i // 2, 2, j, k)).sum(-3)
    a = a.reshape(lead + (i // 2, j // 2, 2, k)).sum(-2)
    return a.reshape(lead + (i // 2, j // 2, k // 2, 2)).sum(-1)


def prolong(a, fine_spatial):
    """P: replicate each coarse cell into its 2x2x2 block, cut to the fine
    spatial shape."""
    fi, fj, fk = fine_spatial
    a = a.repeat_interleave(2, dim=-3)[..., :fi, :, :]
    a = a.repeat_interleave(2, dim=-2)[..., :fj, :]
    return a.repeat_interleave(2, dim=-1)[..., :fk]


def mg_down_ref(diag, links, b, omega):
    """Plain version of mg_down: the operator is upcast to f32."""
    d = diag.float()
    ls = tuple(lk.float() for lk in links)
    x = omega * inv_diag(d) * b
    r = b - apply_level(d, ls, x)
    return x, pool_sum(r)


def mg_up_ref(diag, links, b, x, xc, omega, scale):
    """Plain version of mg_up: the operator is upcast to f32."""
    d = diag.float()
    ls = tuple(lk.float() for lk in links)
    x2 = x + scale * prolong(xc, b.shape[-3:])
    r = b - apply_level(d, ls, x2)
    return x2 + omega * inv_diag(d) * r


def coarse_shape(shape):
    nb, i, j, k = shape
    return (nb, (i + 1) // 2, (j + 1) // 2, (k + 1) // 2)


def _check_level(diag, links, b):
    _build.require(b, "b", torch.float32, ndim=4)
    _build.require(diag, "diag", _OPERATOR_DTYPES, b.shape)
    for ax, lk in enumerate(links):
        _build.require(lk, f"links[{ax}]", diag.dtype, b.shape)


def _suffix(diag):
    return "bf16" if diag.dtype == torch.bfloat16 else "f32"


# the kernels' column tile (csrc/mg_vcycle.cu: TJ x TK, one thread each)
TILE_JK = 16
# blocks of 256 threads an SM holds at once (csrc/mg_vcycle.cu:
# BLOCKS_PER_SM, which caps a thread at 64 registers)
_BLOCKS_PER_SM = 4
# waves of blocks a level should give where its planes allow: enough that
# the last, partly filled wave costs little
_WAVES = 8
# the fewest planes a block marches through: each block also reads the
# plane below its chunk and the one above, which at 2 planes a chunk
# doubles the loads (on an H100 80GB HBM3 at 700 W the 65^3 and 128^3
# levels were faster at 4 than at 2, the 257^3 levels faster with eight
# waves than with four; PERF.md section 6)
_MIN_CHUNK = 4


def plane_chunk(shape, sms: int) -> int:
    """The planes each block of the kernels marches through at level shape
    (nb, I, J, K) on a card of `sms` SMs: an even count (the kernels step
    by i-pairs, and DOWN pools them inside a block), at least _MIN_CHUNK,
    and as large as still gives _WAVES waves of blocks, the chunks of a
    column as equal as they can be."""
    nb, ni, nj, nk = shape
    tiles = nb * -(-nj // TILE_JK) * -(-nk // TILE_JK)
    chunks = -(-(_WAVES * _BLOCKS_PER_SM * sms) // tiles)
    c = -(-ni // chunks)
    return max(_MIN_CHUNK, c + (c & 1))


def _chunk(b) -> int:
    return plane_chunk(b.shape, _build.sm_count(b))


_P, _I, _F = _build.P, _build.I, _build.F
_DOWN_ARGS = (_P,) * 5 + (_I,) * 5 + (_F,) + (_P,) * 2 + (_P,)
_UP_ARGS = (_P,) * 7 + (_I,) * 5 + (_F, _F) + (_P,) + (_P,)


@_build.counted
def mg_down(diag, links, b, omega):
    """One level's DOWN -> (x (nb,I,J,K), rc (nb,ceil(I/2),ceil(J/2),
    ceil(K/2)))."""
    if _build.on_cpu(b, "mg_down"):
        return mg_down_ref(diag, links, b, omega)
    _check_level(diag, links, b)
    nb, ni, nj, nk = b.shape
    x = torch.empty_like(b)
    rc = torch.empty(coarse_shape(b.shape), dtype=torch.float32,
                     device=b.device)
    _build.launch(
        f"flip3d_mg_down_{_suffix(diag)}", _DOWN_ARGS,
        diag.data_ptr(), links[0].data_ptr(), links[1].data_ptr(),
        links[2].data_ptr(), b.data_ptr(), nb, ni, nj, nk, _chunk(b),
        float(omega), x.data_ptr(), rc.data_ptr())
    _build.count(mg_down)
    return x, rc


@_build.counted
def mg_up(diag, links, b, x, xc, omega, scale):
    """One level's UP -> x_out (nb,I,J,K)."""
    if _build.on_cpu(b, "mg_up"):
        return mg_up_ref(diag, links, b, x, xc, omega, scale)
    _check_level(diag, links, b)
    _build.require(x, "x", torch.float32, b.shape)
    _build.require(xc, "xc", torch.float32, coarse_shape(b.shape))
    nb, ni, nj, nk = b.shape
    out = torch.empty_like(b)
    _build.launch(
        f"flip3d_mg_up_{_suffix(diag)}", _UP_ARGS,
        diag.data_ptr(), links[0].data_ptr(), links[1].data_ptr(),
        links[2].data_ptr(), b.data_ptr(), x.data_ptr(), xc.data_ptr(),
        nb, ni, nj, nk, _chunk(b), float(omega), float(scale),
        out.data_ptr())
    _build.count(mg_up)
    return out
