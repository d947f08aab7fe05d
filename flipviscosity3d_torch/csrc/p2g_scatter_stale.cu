// P2G scatter over an UNSORTED stream: per-cell Wyvill weight / momentum
// sums, the liquid-SDF slot table and per-cell counts, with each particle's
// in-cell rank computed here in stream order.
//
// Replaces flipviscosity3d_tpu/ops/pallas_particles.py::scatter_p2g_table
// with inkernel_rank=True (bodies _p2g_chunk_values, _table_chunk_values and
// _rank_from_accumulator), the stale pass A's scatter, with fold_sums False
// (row stride 108) and True (row stride 112, _p2g_chunk_values_folded), at
// pallas_split_terms 1, 2 (split products, p2g_wyvill.cuh) and exact.
//
// Input: particles in their current order, cut into chunks of 512; a
// particle takes part iff covered[q] (its (chunk, home tile) incidence lies
// in the visit plan); the plan's CSR lists, per tile, the ascending ids of
// the chunks that touch it. Output per cell (standard i-major layout), over
// covered particles only:
//   sums[cell, l], sums[cell, 54 + l]  as p2g_scatter.cu, a row of kStride
//                      floats whose lanes 108..kStride are zero
//   table[cell, r, :]  (px, py, pz, 1) of the covered particle whose rank in
//                      stream order among the cell's covered particles is
//                      r < cap; zero for an empty slot
//   counts[cell]       covered particles homed in the cell
// Every output element is written; tiles with no incidence get zeros.
//
// What bounds it on the H100: bytes, as K1. The sums are 432 B per cell
// (0.9 GB at 128^3) and the table cap*16 B; each particle is read once per
// tile that lists its chunk (~28 B). The TPU kernel accumulated one-hot MXU
// products per (chunk, tile) visit and got the ranks from count lanes of the
// accumulator plus a (C, C) compare. Here one block of 16 warps owns one
// tile and keeps the tile's 512 x 108 sums in shared memory (221 KB, the
// whole dynamic budget of a block); it walks the tile's chunks in ascending
// order, staging 256 particles at a time. Warp w owns the tile's local cells
// [32w, 32w + 32): it finds the staged particles homed in its cells with one
// ballot per 32, in stream order, and processes them one at a time with all
// 32 lanes over the 54 faces (two per lane), as K1's warp does over a run.
// Lane c of the warp holds the count of the warp's cell c, so a particle's
// rank is that count before it: deterministic and JAX's stream-order rank,
// with no atomics. A particle of rank < cap writes its slot; the empty slots
// are zeroed at the end. Each cell's sums are added in stream order, by one
// warp, so the result does not vary from run to run. The K-folded form
// differs only in the last loop, which writes the tile's sums out: the
// shared-memory rows stay 108 wide (112 would not fit a block's 227 KB), the
// rows in device memory are kStride apart and their pad lanes are written
// as zero. At 1 split term the shared-memory sums take the bf16 terms; at 2
// the second terms' sums have no room there and are summed in the output
// rows themselves (zeroed first, each element by one lane), then added to
// the first terms' sums as the tile is written out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "p2g_wyvill.cuh"

namespace {

using flip3d::bf16_term;
using flip3d::Face;
using flip3d::face_of;
using flip3d::split_round;
using flip3d::velocity_of;
using flip3d::wyvill;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCells = 512;    // cells per tile = particles per chunk
constexpr int kThreads = 512;  // 16 warps
constexpr int kStage = 256;    // particles staged per round
constexpr int kLanes = 108;
constexpr size_t kSmemBytes =
    sizeof(float) * kCells * kLanes     // the tile's sums
    + sizeof(int) * kStage              // staged local cell id, -1 if absent
    + sizeof(float) * 6 * kStage;       // staged px, py, pz, vx, vy, vz

// Adds x to lane l of a cell's sums as a split product: its first term to
// the shared-memory row s, at 2 terms its second to the output row g.
template <int kTerms>
__device__ __forceinline__ void add_split(float* s, float* g, int l,
                                          float x) {
  if (kTerms == 1 || kTerms == 2) {
    const float t1 = bf16_term(x);
    s[l] = s[l] + t1;
    if (kTerms == 2) g[l] = g[l] + bf16_term(x - t1);
  } else {
    s[l] = s[l] + x;
  }
}

template <int kStride, int kTerms>
__global__ void __launch_bounds__(kThreads, 1) p2g_scatter_stale_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const int* __restrict__ key, const unsigned char* __restrict__ covered,
    int n, const int* __restrict__ tile_ptr,
    const int* __restrict__ tile_chunks, int I, int J, int K, int cap,
    float dx, float c1, float c2, float c3, float r2,
    float* __restrict__ sums, float* __restrict__ table,
    int* __restrict__ counts) {
  extern __shared__ float smem[];
  float* s_sums = smem;
  int* s_loc = reinterpret_cast<int*>(s_sums + kCells * kLanes);
  float* s_p = reinterpret_cast<float*>(s_loc + kStage);  // [6][kStage]

  const int tile = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntj = J / 8, ntk = K / 8;
  const int ti = tile / (ntj * ntk), tj = (tile / ntk) % ntj, tk = tile % ntk;

  for (int e = tid; e < kCells * kLanes; e += kThreads) s_sums[e] = 0.f;
  // the output row of local cell c, standard i-major layout
  auto out_row = [&](int c) {
    return sums + (((int64_t)(ti * 8 + (c >> 6)) * J +
                    (tj * 8 + ((c >> 3) & 7))) * K + tk * 8 + (c & 7)) *
                      kStride;
  };
  if (kTerms == 2)
    for (int e = tid; e < kCells * kLanes; e += kThreads)
      out_row(e / kLanes)[e % kLanes] = 0.f;

  const bool has2 = lane + 32 < 54;
  const Face f0 = face_of(lane);
  const Face f1 = face_of(has2 ? lane + 32 : lane);
  int cnt = 0;  // covered particles so far in local cell warp*32 + lane
  __syncthreads();

  const int c_end = tile_ptr[tile + 1];
  for (int ci = tile_ptr[tile]; ci < c_end; ++ci) {
    const int64_t chunk0 = (int64_t)tile_chunks[ci] * kCells;
    for (int h = 0; h < kCells; h += kStage) {
      if (tid < kStage) {
        const int64_t q = chunk0 + h + tid;
        int loc = -1;
        if (q < n && covered[q]) {
          const int k = key[q];
          if ((k >> 9) == tile) loc = k & 511;
        }
        s_loc[tid] = loc;
        if (loc >= 0) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            s_p[a * kStage + tid] = pos[3 * q + a];
            s_p[(3 + a) * kStage + tid] = vel[3 * q + a];
          }
        }
      }
      __syncthreads();
      for (int s = 0; s < kStage; s += 32) {
        const int mine = s_loc[s + lane];
        unsigned m = __ballot_sync(kFull, mine >= 0 && (mine >> 5) == warp);
        while (m) {
          const int q = s + __ffs(m) - 1;
          m &= m - 1;
          const int c = s_loc[q];
          const int co = c & 31;
          const int rank = __shfl_sync(kFull, cnt, co);
          if (lane == co) ++cnt;
          const float px = s_p[q], py = s_p[kStage + q],
                      pz = s_p[2 * kStage + q];
          const float vx = s_p[3 * kStage + q], vy = s_p[4 * kStage + q],
                      vz = s_p[5 * kStage + q];
          const int gi = ti * 8 + (c >> 6), gj = tj * 8 + ((c >> 3) & 7),
                    gk = tk * 8 + (c & 7);
          const float fgi = (float)gi, fgj = (float)gj, fgk = (float)gk;
          float* row = s_sums + c * kLanes;
          float* grow = kTerms == 2 ? out_row(c) : nullptr;
          const float a =
              wyvill(f0, fgi, fgj, fgk, px, py, pz, dx, c1, c2, c3, r2);
          add_split<kTerms>(row, grow, lane, a);
          add_split<kTerms>(row, grow, 54 + lane,
                            a * velocity_of(f0, vx, vy, vz));
          if (has2) {
            const float b =
                wyvill(f1, fgi, fgj, fgk, px, py, pz, dx, c1, c2, c3, r2);
            add_split<kTerms>(row, grow, lane + 32, b);
            add_split<kTerms>(row, grow, 54 + lane + 32,
                              b * velocity_of(f1, vx, vy, vz));
          }
          if (rank < cap && lane < 4) {
            const int64_t cell = ((int64_t)gi * J + gj) * K + gk;
            table[(cell * cap + rank) * 4 + lane] = split_round<kTerms>(
                lane == 0 ? px : (lane == 1 ? py : (lane == 2 ? pz : 1.0f)));
          }
        }
      }
      __syncthreads();
    }
  }

  for (int e = tid; e < kCells * kStride; e += kThreads) {
    const int c = e / kStride, l = e - c * kStride;
    float* row = out_row(c);
    float v = 0.f;
    if (l < kLanes) {
      v = s_sums[c * kLanes + l];
      if (kTerms == 2) v = v + row[l];
    }
    row[l] = v;
  }
  const int c = warp * 32 + lane;
  const int64_t cell =
      ((int64_t)(ti * 8 + (c >> 6)) * J + (tj * 8 + ((c >> 3) & 7))) * K +
      tk * 8 + (c & 7);
  counts[cell] = cnt;
  float4* slots = reinterpret_cast<float4*>(table) + cell * cap;
  for (int r = cnt < cap ? cnt : cap; r < cap; ++r)
    slots[r] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int kStride>
decltype(&p2g_scatter_stale_kernel<kStride, 3>) kernel_of(int terms) {
  if (terms == 1) return p2g_scatter_stale_kernel<kStride, 1>;
  if (terms == 2) return p2g_scatter_stale_kernel<kStride, 2>;
  if (terms == 3) return p2g_scatter_stale_kernel<kStride, 3>;
  return nullptr;
}

}  // namespace

extern "C" int flip3d_p2g_scatter_stale(
    const float* pos, const float* vel, const int* key,
    const unsigned char* covered, int n, const int* tile_ptr,
    const int* tile_chunks, int I, int J, int K, int cap, float dx, float c1,
    float c2, float c3, float r2, int sum_stride, int terms, float* sums,
    float* table, int* counts, void* stream) {
  decltype(&p2g_scatter_stale_kernel<108, 3>) kernel = nullptr;
  if (sum_stride == 108) kernel = kernel_of<108>(terms);
  if (sum_stride == 112) kernel = kernel_of<112>(terms);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(((int64_t)I * J * K) / kCells);
  kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      pos, vel, key, covered, n, tile_ptr, tile_chunks, I, J, K, cap, dx, c1,
      c2, c3, r2, sums, table, counts);
  return (int)cudaGetLastError();
}
