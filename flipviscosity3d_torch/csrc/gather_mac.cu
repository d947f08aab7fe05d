// G2P gather: trilinear MAC velocity samples at particles, restricted to the
// 2x3x3 face window of each particle's (clamped) home cell.
//
// Replaces flipviscosity3d_tpu/ops/pallas_particles.py::gather_mac (weights
// from _trilinear_weightsT; columns from build_mac_columns), at
// pallas_split_terms 1, 2 (each face value split-rounded, p2g_wyvill.cuh)
// and exact.
//
// out[(g*3 + comp) * n + p] = sum over the 18 window faces o of comp of
//   w(p, o) * grid_g_comp[home(p) + o]     (0 outside the face grid)
// where w is the product over axes of (1 - frac) at corner offset 0 and frac
// at corner offset 1 of floor(p/dx - half-cell shift), taken relative to the
// home cell; a corner that falls outside the window weighs 0 (that is what
// happens to midpoints outside the domain, which the caller masks). Keys
// come in any order: pass B gathers at midpoints in pass-A order.
//
// What bounds it on the H100: bytes, 40 B per particle at two grids (16 B
// of position and key read, 24 B of samples written) and the grids once,
// 0.215 GB at 128^3; its ~850 instructions per particle (two grids) take
// about as long at the card's instruction rate, and bind it at ~1.9x the bytes'
// time (PERF.md). The TPU kernel contracted a per-tile column image
// (build_mac_columns: 54 shifted copies of every grid) against one-hot
// matrices on the MXU. A thread per particle reads the grids directly here,
// so no column image exists. What held the first such kernel back was the
// window: it looped over all 18 faces of each component and grid, with three
// weight products and a branch per face, of which 8 are nonzero, a
// different 8 in each lane, so few of its loads were in flight at once.
//
// So each thread computes its 8 trilinear corners directly: per axis the
// corner cells floor(p/dx - shift) + {0, 1}, each weighted (1 - frac) or
// frac, or 0 where it leaves the window or the grid, and all 8 * n_grids
// loads of a component (predicated, no branches) are in flight before any
// of them is added. The corners are added in the window order of the plain
// version (the component axis first, then the other two in x, y, z order),
// each weight the product over x, y, z, built with -fmad=false: the faces
// the plain version adds beside them weigh 0 and add +-0, which leaves a
// finite sum that started at +0 unchanged, so the samples are bit for bit
// the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "p2g_wyvill.cuh"

namespace {

using flip3d::split_round;

constexpr int kThreads = 256;

struct Grids {
  const float* g[2][3];  // [grid][comp]
};

// n / d and n % d for 0 <= n < 2^24 by a float reciprocal, corrected by one
// step either way: the tile decode without an integer division.
struct DivMod {
  int d;
  float inv;  // 1 / d
  __device__ __forceinline__ int div(int n, int& rem) const {
    int q = (int)((float)n * inv);
    int r = n - q * d;
    if (r < 0) q -= 1, r += d;
    if (r >= d) q += 1, r -= d;
    rem = r;
    return q;
  }
};

template <int kGrids, int kTerms>
__global__ void __launch_bounds__(kThreads)
    gather_mac_kernel(const float* __restrict__ px,
                      const float* __restrict__ py,
                      const float* __restrict__ pz,
                      const int* __restrict__ key, int n, Grids grids, int I,
                      int J, int K, DivMod by_ntk, DivMod by_ntj, float dx,
                      float inv_dx, float* __restrict__ out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int t = key[q];
  const int tile = t >> 9, local = t & 511;
  int tk, tj;
  const int ti = by_ntj.div(by_ntk.div(tile, tk), tj);
  const int home[3] = {ti * 8 + (local >> 6), tj * 8 + ((local >> 3) & 7),
                       tk * 8 + (local & 7)};
  const float p[3] = {px[q], py[q], pz[q]};

  // per axis, p / dx (a product where 1 / dx is exact) and the corner base
  // and fraction in the two frames a component sees an axis in: s = 0 its
  // own axis (shift 0), s = 1 the others (shift 0.5)
  float frac[3][2];
  int base[3][2];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float r = inv_dx != 0.f ? p[ax] * inv_dx : p[ax] / dx;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float f = r - (s == 0 ? 0.f : 0.5f);
      const float b = floorf(f);
      frac[ax][s] = f - b;
      base[ax][s] = (int)b;
    }
  }

#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    const int dims[3] = {I + (comp == 0), J + (comp == 1), K + (comp == 2)};
    // per axis and corner c in {0, 1}: its weight, 0 where the corner
    // leaves the window or the grid
    float wa[3][2];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int s = ax == comp ? 0 : 1;
      const int lo = ax == comp ? 0 : -1;  // the window's offsets: lo .. 1
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int at = base[ax][s] + c;
        const bool ok = (unsigned)(at - home[ax] - lo) <= (unsigned)(1 - lo) &&
                        (unsigned)at < (unsigned)dims[ax];
        wa[ax][c] = ok ? (c == 0 ? 1.0f - frac[ax][s] : frac[ax][s]) : 0.f;
      }
    }
    // corner (0, 0, 0) and the offsets of the others
    const int64_t at0 = ((int64_t)base[0][comp == 0 ? 0 : 1] * dims[1] +
                         base[1][comp == 1 ? 0 : 1]) * dims[2] +
                        base[2][comp == 2 ? 0 : 1];
    const int step[3] = {dims[1] * dims[2], dims[2], 1};
    // the window order: the component axis, then the other two ascending
    const int a0 = comp, a1 = comp == 0 ? 1 : 0, a2 = comp == 2 ? 1 : 2;
    float w[8], v[kGrids][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      int c3[3];
      c3[a0] = e >> 2, c3[a1] = (e >> 1) & 1, c3[a2] = e & 1;
      w[e] = wa[0][c3[0]] * wa[1][c3[1]] * wa[2][c3[2]];
      const int off = c3[0] * step[0] + c3[1] * step[1] + c3[2];
#pragma unroll
      for (int g = 0; g < kGrids; ++g) {
        float val = 0.f;
        if (w[e] != 0.f) val = __ldg(grids.g[g][comp] + at0 + off);
        v[g][e] = split_round<kTerms>(val);
      }
    }
#pragma unroll
    for (int g = 0; g < kGrids; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = acc + w[e] * v[g][e];
      out[(int64_t)(g * 3 + comp) * n + q] = acc;
    }
  }
}

template <int kGrids>
int launch(int terms, unsigned blocks, cudaStream_t stream, const float* px,
           const float* py, const float* pz, const int* key, int n,
           const Grids& grids, int I, int J, int K, float dx, float inv_dx,
           float* out) {
  const DivMod by_ntk{K / 8, 1.0f / (float)(K / 8)};
  const DivMod by_ntj{J / 8, 1.0f / (float)(J / 8)};
  decltype(&gather_mac_kernel<kGrids, 3>) kernel = nullptr;
  if (terms == 1) kernel = gather_mac_kernel<kGrids, 1>;
  if (terms == 2) kernel = gather_mac_kernel<kGrids, 2>;
  if (terms == 3) kernel = gather_mac_kernel<kGrids, 3>;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, 0, stream>>>(px, py, pz, key, n, grids, I, J, K,
                                          by_ntk, by_ntj, dx, inv_dx, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flip3d_gather_mac(const float* px, const float* py,
                                 const float* pz, const int* key, int n,
                                 int n_grids, const float* u0, const float* v0,
                                 const float* w0, const float* u1,
                                 const float* v1, const float* w1, int I,
                                 int J, int K, float dx, float inv_dx,
                                 int terms, float* out, void* stream) {
  Grids grids{{{u0, v0, w0}, {u1, v1, w1}}};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_grids == 1)
    return launch<1>(terms, blocks, s, px, py, pz, key, n, grids, I, J, K, dx,
                     inv_dx, out);
  if (n_grids == 2)
    return launch<2>(terms, blocks, s, px, py, pz, key, n, grids, I, J, K, dx,
                     inv_dx, out);
  return (int)cudaErrorInvalidValue;
}
