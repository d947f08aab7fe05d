// The two revisit probes: a W-major row scatter and row gather over
// tile-major keys, with F floats per row.
//
//   scatter_revisit: out[key_p, :] += vals[p, :] over keys sorted ascending;
//                    out is (n_cells, F) = (n_tiles, 512, F), and a cell no
//                    particle touches is zero;
//   gather_revisit:  out[p, :] = cols[key_p, :] for p < n, zero for the pad
//                    rows n <= p < n_rows.
//
// Replace scripts/gather_perf_probe.py::scatter_revisit and
// ::gather_revisit, which ran one grid step per (tile, chunk) visit and
// contracted a (C, 512) one-hot of the chunk's pre-localised keys with the
// chunk's values (or the tile's columns) on the MXU, revisiting the output
// block while the visit stayed on the same tile (or chunk). Both take the
// absolute int32 keys here; there is no visit table.
//
// What bounds them on the H100: bytes (F = 128: 512 B per row on both
// sides).
//
// Scatter: the sort makes each cell's particles one contiguous run, so one
// warp owns one cell: it finds the run by two 32-lane searches of the keys
// (sorted_runs.cuh), walks it in stream order with each
// lane summing its floats of every row (coalesced 128-float reads), and
// writes the cell's row, zero for an empty run. No atomics: the order of
// summation is the stream's, the same in every call. Rows wider than 128
// floats are summed in passes of 128.
//
// Gather: one warp per output row copies F contiguous floats, as float4
// where F is a multiple of 4. A copy, so the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

constexpr int kWarps = 8;   // warps (cells or rows) per block

__global__ void scatter_revisit_kernel(const int* __restrict__ key, int n,
                                       const float* __restrict__ vals,
                                       int n_cells, int F,
                                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t cell = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cell >= n_cells) return;
  const int start = flip3d::warp_lower_bound(key, 0, n, (int)cell);
  const int end = flip3d::warp_lower_bound(key, start, n, (int)cell + 1);
  for (int f0 = 0; f0 < F; f0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = start; q < end; ++q) {
      const float* __restrict__ row = vals + (int64_t)q * F + f0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int f = lane + 32 * s;
        if (f0 + f < F) acc[s] = acc[s] + row[f];
      }
    }
    float* __restrict__ dst = out + cell * F + f0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int f = lane + 32 * s;
      if (f0 + f < F) dst[f] = acc[s];
    }
  }
}

// V: float or float4; f is F in units of V.
template <typename V>
__global__ void gather_revisit_kernel(const int* __restrict__ key, int n,
                                      int n_rows, const V* __restrict__ cols,
                                      int f, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n_rows) return;
  V* __restrict__ dst = out + p * f;
  if (p < n) {
    const V* __restrict__ src = cols + (int64_t)key[p] * f;
    for (int e = lane; e < f; e += 32) dst[e] = src[e];
  } else {
    const V zero = V();
    for (int e = lane; e < f; e += 32) dst[e] = zero;
  }
}

}  // namespace

extern "C" int flip3d_scatter_revisit(const int* key, int n, const float* vals,
                                      int n_cells, int F, float* out,
                                      void* stream) {
  if (n_cells == 0 || F == 0) return 0;
  const unsigned blocks = (unsigned)(((int64_t)n_cells + kWarps - 1) / kWarps);
  scatter_revisit_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      key, n, vals, n_cells, F, out);
  return (int)cudaGetLastError();
}

extern "C" int flip3d_gather_revisit(const int* key, int n, int n_rows,
                                     const float* cols, int F, float* out,
                                     void* stream) {
  if (n_rows == 0 || F == 0) return 0;
  const unsigned blocks = (unsigned)(((int64_t)n_rows + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (F % 4 == 0)
    gather_revisit_kernel<float4><<<blocks, kWarps * 32, 0, s>>>(
        key, n, n_rows, (const float4*)cols, F / 4, (float4*)out);
  else
    gather_revisit_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        key, n, n_rows, cols, F, out);
  return (int)cudaGetLastError();
}
