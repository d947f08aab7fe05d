// P2G scatter: per-cell Wyvill weight / momentum sums and the liquid-SDF
// slot table, from particles sorted by tile-major home-cell key.
//
// Replaces flipviscosity3d_tpu/ops/pallas_particles.py::scatter_p2g_table
// (bodies _p2g_chunk_values, _p2g_chunk_values_folded and
// _table_chunk_values), the sorted-stream form (inkernel_rank=False), with
// fold_sums False (row stride 108) and True (row stride 112), at
// pallas_split_terms 1, 2 (split products, p2g_wyvill.cuh) and exact.
//
// Output per cell (standard i-major layout), a row of kStride floats:
//   sums[cell, l]      l < 54: sum of Wyvill weights of window face l
//   sums[cell, 54 + l]         sum of weight * velocity component
//   sums[cell, 108..kStride)   zero (the K-folded form's pad lanes)
//   table[cell, r, :]  (px, py, pz, 1) of the particle of in-cell rank r < cap,
//                      zero for an empty slot
// with lane l = comp*18 + oidx over the 2x3x3 face window of each MAC
// component (p2g_abs_offset). Every output element is written. The ranks of
// a cell's particles are 0 .. count-1 (the run ranks of the sorted stream),
// so a cell's slots [count, cap) are its empty ones.
//
// What bounds it on the H100: bytes. The sums are 432 B per cell (448 B
// folded) and the table cap*16 B, 1.44 GB at 128^3 and cap 16, against 32 B
// per particle read; ~32 flops per (particle, face), 7 GFLOP at 128^3, are a
// fifth of the time the bytes take. The TPU kernel turned the scatter into
// one-hot MXU matmuls over visit plans; here the sort makes the particles of
// any run of consecutive keys one contiguous run of the stream, and the
// kernel has to keep the write stream going while it sums. What stood in
// the way was latency: a warp per cell found its run by two binary searches
// (~22 dependent loads each) in lane 0 and walked it with seven broadcast
// loads per particle, and every empty cell paid the searches too.
//
// So one warp owns 32 consecutive keys (cells) and finds their whole run
// [start, end) with two 32-lane searches (warp_lower_bound: ~5 dependent
// loads each), then sums it by the walk of p2g_cells.cuh (sum_cells: 32
// particles a batch, coalesced, the next batch in flight; lane l on window
// faces l and l + 32 in registers; a cell closed where the key changes;
// empty cells as float4 zeros). Each cell's sums are added in stream order
// with -fmad=false and the weight expression of _p2g_chunk_values, so the
// result is bit for bit that of the warp-per-cell kernel this replaces and
// does not vary from run to run; no atomics, no zero-fill pass. What holds
// it at ~1.6x its bound now is the write stream itself, rows written by
// four scalar stores at ~2.2 TB/s (PERF.md).
//
// The K-folded form (I, J, K*112) of the TPU kernel is a second kernel body
// there (the one-hot splits so that the MXU result is already the folded
// block). Here the fold is only where a cell's row is written: cell * 112 in
// place of cell * 108, with the 4 pad lanes written as zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "p2g_cells.cuh"
#include "sorted_runs.cuh"

namespace {

using flip3d::CellRows;
using flip3d::Particle;
using flip3d::sum_cells;
using flip3d::warp_lower_bound;

constexpr int kWarps = 8;    // warps per block
constexpr int kCells = 32;   // consecutive tile-major keys (cells) per warp

// The sorted stream as sum_cells reads it: particle q of the run is stream
// element q, with its rank given.
struct SortedStream {
  const float* __restrict__ pos;
  const float* __restrict__ vel;
  const int* __restrict__ key;
  const int* __restrict__ rank;
  int end, t0;
  float x = 0.f, y = 0.f, z = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  int k = 0, r = 0;

  __device__ __forceinline__ void load(int q) {
    if (q < end) {
      x = pos[3 * (int64_t)q], y = pos[3 * (int64_t)q + 1];
      z = pos[3 * (int64_t)q + 2];
      vx = vel[3 * (int64_t)q], vy = vel[3 * (int64_t)q + 1];
      vz = vel[3 * (int64_t)q + 2];
      k = key[q], r = rank[q];
    }
  }
  __device__ __forceinline__ Particle next(int) const {
    return Particle{x, y, z, vx, vy, vz, k - t0, r};
  }
};

template <int kStride, int kTerms>
__global__ void __launch_bounds__(kWarps * 32, 4)
    p2g_scatter_kernel(const float* __restrict__ pos,
                       const float* __restrict__ vel,
                       const int* __restrict__ key,
                       const int* __restrict__ rank, int n, int I, int J,
                       int K, int cap, float dx, float c1, float c2, float c3,
                       float r2, float* __restrict__ sums,
                       float* __restrict__ table) {
  // a batch of 32 particles per warp: (px, py, pz, vx), (vy, vz, cell, -)
  __shared__ float4 s_batch[kWarps][32][2];
  const int warp = threadIdx.x >> 5;
  const int64_t first = ((int64_t)blockIdx.x * kWarps + warp) * kCells;
  if (first >= (int64_t)I * J * K) return;
  const int t0 = (int)first;

  const int start = warp_lower_bound(key, 0, n, t0);
  const int end = warp_lower_bound(key, start, n, t0 + kCells);
  // the warp's cells: one i, four j rows of eight k in a tile; cell i of
  // the warp (key t0 + i) is (gi, gj0 + i / 8, gk0 + i % 8)
  const int ntj = J / 8, ntk = K / 8;
  const int tile = t0 >> 9, local0 = t0 & 511;
  const int gi = (tile / (ntj * ntk)) * 8 + (local0 >> 6);
  const int gj0 = ((tile / ntk) % ntj) * 8 + ((local0 >> 3) & 7);
  const int gk0 = (tile % ntk) * 8;

  SortedStream src{pos, vel, key, rank, end, t0};
  const CellRows<kStride, kTerms> out{
      sums, reinterpret_cast<float4*>(table),
      ((int64_t)gi * J + gj0) * K + gk0, K, cap};
  sum_cells<kTerms>(src, out, s_batch[warp], start, end, gi, gj0, gk0, cap,
                    dx, c1, c2, c3, r2);
}

template <int kStride>
int launch(int terms, unsigned blocks, cudaStream_t stream, const float* pos,
           const float* vel, const int* key, const int* rank, int n, int I,
           int J, int K, int cap, float dx, float c1, float c2, float c3,
           float r2, float* sums, float* table) {
  decltype(&p2g_scatter_kernel<kStride, 3>) kernel = nullptr;
  if (terms == 1) kernel = p2g_scatter_kernel<kStride, 1>;
  if (terms == 2) kernel = p2g_scatter_kernel<kStride, 2>;
  if (terms == 3) kernel = p2g_scatter_kernel<kStride, 3>;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(pos, vel, key, rank, n, I, J, K,
                                             cap, dx, c1, c2, c3, r2, sums,
                                             table);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flip3d_p2g_scatter(const float* pos, const float* vel,
                                  const int* key, const int* rank, int n,
                                  int I, int J, int K, int cap, float dx,
                                  float c1, float c2, float c3, float r2,
                                  int sum_stride, int terms, float* sums,
                                  float* table, void* stream) {
  const int64_t n_cells = (int64_t)I * J * K;
  const int64_t per_block = (int64_t)kWarps * kCells;
  const unsigned blocks = (unsigned)((n_cells + per_block - 1) / per_block);
  const cudaStream_t s = (cudaStream_t)stream;
  if (sum_stride == 108)
    return launch<108>(terms, blocks, s, pos, vel, key, rank, n, I, J, K, cap,
                       dx, c1, c2, c3, r2, sums, table);
  if (sum_stride == 112)
    return launch<112>(terms, blocks, s, pos, vel, key, rank, n, I, J, K, cap,
                       dx, c1, c2, c3, r2, sums, table);
  return (int)cudaErrorInvalidValue;
}
