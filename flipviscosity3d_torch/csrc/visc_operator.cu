// K13 visc_operator: the coupled operator of the viscosity solve.
//
// Replaces no TPU kernel: the JAX package leaves this operator to XLA
// (flipviscosity3d_tpu/solvers/viscosity.py::apply_viscosity_matrix), and
// the port ran it as plain PyTorch (solvers/viscosity.py::_apply_coupling
// plus diag * x): 42 shifted reads, each a full temporary grid, 45 products
// and ~45 sums, about 170 launches over full grids an apply. It runs once a
// CG iteration of the viscosity solve, once for the warm start's residual
// and once in the system build (the RHS coupling of the solid-Dirichlet
// velocities, without diag).
//
// What it computes: for x = (xu, xv, xw) of any three 3-D shapes (the
// solve's (I+1,J,K), (I,J+1,K), (I,J,K+1), or the slab pipeline's halo'd
// slabs), y_c = diag_c * x_c + C_c(x) at every cell of component c's shape.
// C_c is the 14 neighbour couplings of _apply_coupling: six same-component
// and eight cross-component terms, each a premasked factor grid (r, l, t,
// b, f, k) times x at an offset of -1, 0 or +1 on each axis, 0 where the
// offset leaves that x's grid. Without diag it computes C(x) alone.
//
// What bounds it on the H100: bytes. Per cell of the union domain it reads
// 18 factors, 3 diagonals and 3 x values and writes 3 outputs: 27 f32
// grids, 108 bytes, against ~90 flops. So each byte should leave device
// memory once, in coalesced rows.
//
// The design. A block of 256 threads owns a 32 (k) x 8 (j) tile of columns
// of the union domain (the largest extent of the three shapes on each axis)
// and marches along i through a chunk of planes (the wrapper sizes it,
// solvers/viscosity.py::plane_chunk). A warp is one j row of 32 k, so each
// row load is coalesced.
// - Planes i-1, i and i+1 of the three x, with a one-cell j/k halo, sit in
//   shared memory, 0 outside each x's own shape. The halo has its corners:
//   yv reads xw at (j-1, k+1) and yw reads xv at (j+1, k-1).
// - Each component has a ring of four shared planes. The step that computes
//   plane i loads plane i+2 into the fourth, so one __syncthreads a step
//   suffices.
// - Each x value is loaded about 1.3 times (the halo; the neighbours' loads
//   mostly hit L2). Each factor, diagonal and output is touched once, by the
//   thread of its column.
// - A step issues all its loads (the next x plane, the own cell's 18
//   factors and 3 diagonals) before its arithmetic.
// - Offsets are 32-bit (the wrapper checks that each grid has fewer than
//   2^31 cells).
//
// Rounding: the library is built with -fmad=false, and each sum keeps
// _apply_coupling's order. The running sum starts at (-f_r) * x(+1); each
// further product, rounded on its own, is subtracted or added as written
// there; y = diag * x + c comes last. So the result is bit-equal to the
// plain version, out-of-range neighbours included (both multiply by 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;                          // k columns of a tile
constexpr int TJ = 8;                           // j rows of a tile
constexpr int NT = TK * TJ;                     // threads of a block
constexpr int SK = TK + 2;                      // shared row: tile + k halo
constexpr int SJ = TJ + 2;                      // shared rows: tile + j halo
constexpr int PLANE = SJ * SK;                  // shared cells of a plane
constexpr int LOADS = (PLANE + NT - 1) / NT;    // of them a thread loads
constexpr int RING = 4;                         // shared planes a component
// blocks an SM holds at once (solvers/viscosity.py::_BLOCKS_PER_SM): 64
// registers a thread
constexpr int BLOCKS_PER_SM = 4;

// the factor grids of a component, in _apply_coupling's keys
enum { FR, FL, FT, FB, FF, FK };

struct Comp {
  const float* x;
  const float* f[6];
  const float* d;  // null: C(x) alone
  float* y;
  int I, J, K;
};

struct Args {
  Comp c[3];
  int I, J, K;  // the union domain
  int chunk;
};

// the ring slot of plane p >= -1
__device__ __forceinline__ int ring(int p) { return (p + 1) & (RING - 1); }

// This thread's cells of plane p of the three x (tile and halo), 0 outside
// each x's shape.
__device__ __forceinline__ void fetch(const Args& a, int p, int j0, int k0,
                                      float (&v)[3][LOADS]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const Comp& m = a.c[c];
    const bool plane = p >= 0 && p < m.I;
#pragma unroll
    for (int n = 0; n < LOADS; ++n) {
      const int idx = (int)threadIdx.x + n * NT;
      const int hj = idx / SK, hk = idx - hj * SK;
      const int gj = j0 - 1 + hj, gk = k0 - 1 + hk;
      float val = 0.f;
      if (idx < PLANE && plane && gj >= 0 && gj < m.J && gk >= 0 &&
          gk < m.K)
        val = __ldg(m.x + (p * m.J + gj) * m.K + gk);
      v[c][n] = val;
    }
  }
}

__device__ __forceinline__ void stash(float (*xs)[RING][PLANE], int p,
                                      const float (&v)[3][LOADS]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < LOADS; ++n) {
      const int idx = (int)threadIdx.x + n * NT;
      if (idx < PLANE) xs[c][ring(p)][idx] = v[c][n];
    }
}

// The own cell's factors and diagonal of one component at plane i.
struct Own {
  float f[6];
  float d;
  int off;
  bool in;
};

__device__ __forceinline__ Own own(const Comp& m, int i, int j, int k) {
  Own o;
  o.in = i < m.I && j < m.J && k < m.K;
  o.off = 0;
  o.d = 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) o.f[q] = 0.f;
  if (o.in) {
    o.off = (i * m.J + j) * m.K + k;
#pragma unroll
    for (int q = 0; q < 6; ++q) o.f[q] = __ldg(m.f[q] + o.off);
    if (m.d) o.d = __ldg(m.d + o.off);
  }
  return o;
}

// Planes i-1, i, i+1 of the three x in shared memory; s is the own slot,
// so s +- 1 is k +- 1 and s +- SK is j +- 1.
struct Planes {
  const float *u0, *u1, *u2, *v0, *v1, *v2, *w0, *w1, *w2;
};

// _apply_coupling's yu
__device__ __forceinline__ float row_u(const float* f, const Planes& p,
                                       int s) {
  float c = (-f[FR]) * p.u2[s];
  c = c - f[FL] * p.u0[s];
  c = c - f[FT] * p.u1[s + SK];
  c = c - f[FB] * p.u1[s - SK];
  c = c - f[FF] * p.u1[s + 1];
  c = c - f[FK] * p.u1[s - 1];
  c = c - f[FT] * p.v1[s + SK];   // xv (0, 1, 0)
  c = c + f[FT] * p.v0[s + SK];   // xv (-1, 1, 0)
  c = c + f[FB] * p.v1[s];        // xv (0, 0, 0)
  c = c - f[FB] * p.v0[s];        // xv (-1, 0, 0)
  c = c - f[FF] * p.w1[s + 1];    // xw (0, 0, 1)
  c = c + f[FF] * p.w0[s + 1];    // xw (-1, 0, 1)
  c = c + f[FK] * p.w1[s];        // xw (0, 0, 0)
  c = c - f[FK] * p.w0[s];        // xw (-1, 0, 0)
  return c;
}

// _apply_coupling's yv
__device__ __forceinline__ float row_v(const float* f, const Planes& p,
                                       int s) {
  float c = (-f[FR]) * p.v2[s];
  c = c - f[FL] * p.v0[s];
  c = c - f[FT] * p.v1[s + SK];
  c = c - f[FB] * p.v1[s - SK];
  c = c - f[FF] * p.v1[s + 1];
  c = c - f[FK] * p.v1[s - 1];
  c = c - f[FR] * p.u2[s];            // xu (1, 0, 0)
  c = c + f[FR] * p.u2[s - SK];       // xu (1, -1, 0)
  c = c + f[FL] * p.u1[s];            // xu (0, 0, 0)
  c = c - f[FL] * p.u1[s - SK];       // xu (0, -1, 0)
  c = c - f[FF] * p.w1[s + 1];        // xw (0, 0, 1)
  c = c + f[FF] * p.w1[s - SK + 1];   // xw (0, -1, 1)
  c = c + f[FK] * p.w1[s];            // xw (0, 0, 0)
  c = c - f[FK] * p.w1[s - SK];       // xw (0, -1, 0)
  return c;
}

// _apply_coupling's yw
__device__ __forceinline__ float row_w(const float* f, const Planes& p,
                                       int s) {
  float c = (-f[FR]) * p.w2[s];
  c = c - f[FL] * p.w0[s];
  c = c - f[FT] * p.w1[s + SK];
  c = c - f[FB] * p.w1[s - SK];
  c = c - f[FF] * p.w1[s + 1];
  c = c - f[FK] * p.w1[s - 1];
  c = c - f[FR] * p.u2[s];            // xu (1, 0, 0)
  c = c + f[FR] * p.u2[s - 1];        // xu (1, 0, -1)
  c = c + f[FL] * p.u1[s];            // xu (0, 0, 0)
  c = c - f[FL] * p.u1[s - 1];        // xu (0, 0, -1)
  c = c - f[FT] * p.v1[s + SK];       // xv (0, 1, 0)
  c = c + f[FT] * p.v1[s + SK - 1];   // xv (0, 1, -1)
  c = c + f[FB] * p.v1[s];            // xv (0, 0, 0)
  c = c - f[FB] * p.v1[s - 1];        // xv (0, 0, -1)
  return c;
}

// y = diag * x + c, or c without diag
__device__ __forceinline__ void emit(const Comp& m, const Own& o, float c,
                                     float x) {
  m.y[o.off] = m.d ? o.d * x + c : c;
}

__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
    visc_operator_kernel(const Args a) {
  __shared__ float xs[3][RING][PLANE];
  const int tiles_k = (a.K + TK - 1) / TK, tiles_j = (a.J + TJ - 1) / TJ;
  int bx = (int)blockIdx.x;
  const int k0 = (bx % tiles_k) * TK;
  bx /= tiles_k;
  const int j0 = (bx % tiles_j) * TJ;
  bx /= tiles_j;
  const int ia = bx * a.chunk, ib = min(ia + a.chunk, a.I);
  const int t = (int)threadIdx.x;
  const int j = j0 + t / TK, k = k0 + t % TK;
  const int s = (t / TK + 1) * SK + t % TK + 1;

  float v[3][LOADS];
  for (int p = ia - 1; p <= ia + 1; ++p) {
    fetch(a, p, j0, k0, v);
    stash(xs, p, v);
  }
  __syncthreads();
  for (int i = ia; i < ib; ++i) {
    // plane i+2 is the +i neighbour of the step after, up to plane ib
    const bool next = i + 2 <= ib;
    if (next) fetch(a, i + 2, j0, k0, v);
    const Own ou = own(a.c[0], i, j, k);
    const Own ov = own(a.c[1], i, j, k);
    const Own ow = own(a.c[2], i, j, k);
    const int r0 = ring(i - 1), r1 = ring(i), r2 = ring(i + 1);
    const Planes p{xs[0][r0], xs[0][r1], xs[0][r2], xs[1][r0], xs[1][r1],
                   xs[1][r2], xs[2][r0], xs[2][r1], xs[2][r2]};
    if (ou.in) emit(a.c[0], ou, row_u(ou.f, p, s), p.u1[s]);
    if (ov.in) emit(a.c[1], ov, row_v(ov.f, p, s), p.v1[s]);
    if (ow.in) emit(a.c[2], ow, row_w(ow.f, p, s), p.w1[s]);
    if (next) stash(xs, i + 2, v);
    __syncthreads();
  }
}

}  // namespace

// ptrs: per component (u, v, w) x, the factors r, l, t, b, f, k, diag
// (null for C(x) alone) and y: 27 pointers. dims: per component I, J, K.
extern "C" int flip3d_visc_operator(const void* const* ptrs, const int* dims,
                                    int chunk, void* stream) {
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.I = a.J = a.K = 0;
  for (int c = 0; c < 3; ++c) {
    const void* const* q = ptrs + 9 * c;
    Comp& m = a.c[c];
    m.x = (const float*)q[0];
    for (int f = 0; f < 6; ++f) m.f[f] = (const float*)q[1 + f];
    m.d = (const float*)q[7];
    m.y = (float*)q[8];
    m.I = dims[3 * c];
    m.J = dims[3 * c + 1];
    m.K = dims[3 * c + 2];
    a.I = a.I > m.I ? a.I : m.I;
    a.J = a.J > m.J ? a.J : m.J;
    a.K = a.K > m.K ? a.K : m.K;
  }
  a.chunk = chunk;
  const int64_t blocks = (int64_t)((a.I + chunk - 1) / chunk) *
                         ((a.J + TJ - 1) / TJ) * ((a.K + TK - 1) / TK);
  if (blocks == 0) return 0;
  visc_operator_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
