// G2P gather: trilinear MAC velocity samples at particles, restricted to the
// 2x3x3 face window of each particle's (clamped) home cell.
//
// Replaces flipviscosity3d_tpu/ops/pallas_particles.py::gather_mac (weights
// from _trilinear_weightsT; columns from build_mac_columns).
//
// out[(g*3 + comp) * n + p] = sum over the 18 window faces o of comp of
//   w(p, o) * grid_g_comp[home(p) + o]     (0 outside the face grid)
// where w is the product over axes of (1 - frac) at corner offset 0 and frac
// at corner offset 1 of floor(p/dx - half-cell shift), taken relative to the
// home cell; a corner that falls outside the window weighs 0 (that is what
// happens to midpoints outside the domain, which the caller masks).
//
// What bounds it on the H100: bytes. Per particle it reads 16 B of position
// and key and writes 12 B per grid; the 8 nonzero corners of each of 3*n_grids
// components are gathered from the face grids (4 B each), which a sorted
// stream keeps in L1/L2. The TPU kernel contracted a per-tile column image
// (build_mac_columns: 54 shifted copies of every grid) against one-hot
// matrices on the MXU; here one thread per particle reads u, v and w
// directly, so no column image exists, and skips the loads of the 10 window
// faces whose weight is 0. The sum over faces runs in window order, as the
// plain version does (built with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Grids {
  const float* g[2][3];  // [grid][comp]
};

__global__ void gather_mac_kernel(const float* __restrict__ px,
                                  const float* __restrict__ py,
                                  const float* __restrict__ pz,
                                  const int* __restrict__ key, int n,
                                  int n_grids, Grids grids, int I, int J,
                                  int K, float dx, float* __restrict__ out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int t = key[q];
  const int ntj = J / 8, ntk = K / 8;
  const int tile = t >> 9, local = t & 511;
  const int home[3] = {(tile / (ntj * ntk)) * 8 + (local >> 6),
                       ((tile / ntk) % ntj) * 8 + ((local >> 3) & 7),
                       (tile % ntk) * 8 + (local & 7)};
  const float p[3] = {px[q], py[q], pz[q]};

#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    int delta[3];
    float frac[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float off = ax == comp ? 0.f : 0.5f;
      const float fr = p[ax] / dx - off;
      const float b = floorf(fr);
      frac[ax] = fr - b;
      delta[ax] = (int)b - home[ax];
    }
    const int dims[3] = {I + (comp == 0), J + (comp == 1), K + (comp == 2)};
    for (int g = 0; g < n_grids; ++g) {
      const float* __restrict__ grid = grids.g[g][comp];
      float acc = 0.f;
#pragma unroll
      for (int oidx = 0; oidx < 18; ++oidx) {
        const int ox = oidx / 9, oy = (oidx / 3) % 3 - 1, oz = oidx % 3 - 1;
        const int o[3] = {comp == 0 ? ox : oy,
                          comp == 0 ? oy : (comp == 1 ? ox : oz),
                          comp == 2 ? ox : oz};
        float w = 1.f;
        bool inside = true;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const int corner = o[ax] - delta[ax];
          const float wa =
              corner == 0 ? 1.0f - frac[ax] : (corner == 1 ? frac[ax] : 0.f);
          w = ax == 0 ? wa : w * wa;
          const int c = home[ax] + o[ax];
          inside = inside && c >= 0 && c < dims[ax];
        }
        if (w != 0.f) {
          const float val =
              inside ? grid[((int64_t)(home[0] + o[0]) * dims[1] +
                             (home[1] + o[1])) *
                                dims[2] +
                            (home[2] + o[2])]
                     : 0.f;
          acc = acc + w * val;
        }
      }
      out[(int64_t)(g * 3 + comp) * n + q] = acc;
    }
  }
}

}  // namespace

extern "C" int flip3d_gather_mac(const float* px, const float* py,
                                 const float* pz, const int* key, int n,
                                 int n_grids, const float* u0, const float* v0,
                                 const float* w0, const float* u1,
                                 const float* v1, const float* w1, int I,
                                 int J, int K, float dx, float* out,
                                 void* stream) {
  Grids grids{{{u0, v0, w0}, {u1, v1, w1}}};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  gather_mac_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      px, py, pz, key, n, n_grids, grids, I, J, K, dx, out);
  return (int)cudaGetLastError();
}
