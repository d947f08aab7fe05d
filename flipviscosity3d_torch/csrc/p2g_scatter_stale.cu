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
// accumulator plus a (C, C) compare.
//
// Here the scatter runs in two halves. The order half puts the taking
// particles in the order of a sorted stream without moving them: the
// stable order by (tile, local cell, stream position), written as one int32
// stream index per particle, `order`, and per tile the offset of its run,
// `tile_off` (n_tiles + 1). Three kernels, each a block per tile except the
// scan:
//   count  walks the tile's CSR chunks and counts the covered particles of
//          each of its cells (shared-memory atomics: a count does not
//          depend on their order); writes counts and the tile's total;
//   scan   turns the totals into tile_off (one block);
//   place  walks the chunks again in ascending order, 16 warps over the
//          chunk's 512 particles. A particle's rank is the count of its
//          cell's particles in earlier chunks, plus those in earlier warps
//          of this chunk (each warp's leaders leave the sizes of their
//          groups, __match_any_sync, in shared memory), plus the lanes of
//          its group below it: its stream-order rank, deterministic, no
//          atomics deciding order. It writes q at tile_off + the cell's
//          start + rank.
// The sums half is K1 over that order (sum_cells of p2g_cells.cuh): a block
// per tile, warp w on local cells [32w, 32w + 32), whose runs follow from
// the counts by a block scan; the walk reads each particle through `order`
// and takes its rank as its distance from its cell's start. Each cell's sums
// are added in stream order, as the single-pass kernel this replaces added
// them (a 16-warp block per tile with the tile's 512 x 108 sums in shared
// memory, one block an SM), so the result is bit for bit the same at every
// stride and split. A tile with no covered particle costs the count kernel
// its zero counts and the sums kernel its zero rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "p2g_cells.cuh"

namespace {

using flip3d::CellRows;
using flip3d::Particle;
using flip3d::sum_cells;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCells = 512;        // cells per tile = particles per chunk
constexpr int kWarps = 16;         // a block per tile: a thread per cell
constexpr int kThreads = kWarps * 32;
constexpr int kScanThreads = 1024;

// The standard-layout index of local cell c of tile (ti, tj, tk).
__device__ __forceinline__ int64_t cell_index(int ti, int tj, int tk, int c,
                                              int J, int K) {
  return ((int64_t)(ti * 8 + (c >> 6)) * J + (tj * 8 + ((c >> 3) & 7))) * K +
         tk * 8 + (c & 7);
}

// The exclusive prefix of v over the block's threads in thread order, and
// in *total the block's sum. Every thread calls; s_warp holds a value per
// warp.
template <int kBlockWarps>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    const int s = s_warp[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Stream element q's local cell in `tile` if it takes part, else -1.
__device__ __forceinline__ int local_cell(const int* __restrict__ key,
                                          const unsigned char* __restrict__
                                              covered,
                                          int64_t q, int n, int tile) {
  if (q < n && covered[q]) {
    const int k = key[q];
    if ((k >> 9) == tile) return k & 511;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads) stale_count_kernel(
    const int* __restrict__ key, const unsigned char* __restrict__ covered,
    int n, const int* __restrict__ tile_ptr,
    const int* __restrict__ tile_chunks, int J, int K,
    int* __restrict__ counts, int* __restrict__ tile_off) {
  __shared__ int s_count[kCells];
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int ntj = J / 8, ntk = K / 8;
  const int ti = tile / (ntj * ntk), tj = (tile / ntk) % ntj, tk = tile % ntk;
  s_count[tid] = 0;
  __syncthreads();
  const int c_end = tile_ptr[tile + 1];
  for (int ci = tile_ptr[tile]; ci < c_end; ++ci) {
    const int loc = local_cell(key, covered,
                               (int64_t)tile_chunks[ci] * kCells + tid, n,
                               tile);
    if (loc >= 0) atomicAdd(&s_count[loc], 1);
  }
  __syncthreads();
  const int cnt = s_count[tid];
  counts[cell_index(ti, tj, tk, tid, J, K)] = cnt;
  int total;
  block_exclusive_scan<kWarps>(cnt, s_warp, &total);
  if (tid == 0) {
    tile_off[tile + 1] = total;
    if (tile == 0) tile_off[0] = 0;
  }
}

// tile_off[1..n_tiles] from per-tile totals to the running sums, in place.
__global__ void __launch_bounds__(kScanThreads) stale_scan_kernel(
    int* __restrict__ tile_off, int n_tiles) {
  __shared__ int s_warp[kScanThreads / 32];
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(n_tiles, (int)threadIdx.x * per);
  const int hi = min(n_tiles, lo + per);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += tile_off[1 + t];
  int total;
  int run = block_exclusive_scan<kScanThreads / 32>(sum, s_warp, &total);
  for (int t = lo; t < hi; ++t) {
    run += tile_off[1 + t];
    tile_off[1 + t] = run;
  }
}

__global__ void __launch_bounds__(kThreads) stale_place_kernel(
    const int* __restrict__ key, const unsigned char* __restrict__ covered,
    int n, const int* __restrict__ tile_ptr,
    const int* __restrict__ tile_chunks, int J, int K,
    const int* __restrict__ counts, const int* __restrict__ tile_off,
    int* __restrict__ order) {
  // s_next[c]: where the next particle of local cell c goes; s_group[w][c]:
  // the particles of cell c in warp w of the current chunk (0 elsewhere)
  __shared__ int s_next[kCells];
  __shared__ int s_group[kWarps][kCells];
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int base = tile_off[tile];
  if (tile_off[tile + 1] == base) return;  // no covered particle
  const int ntj = J / 8, ntk = K / 8;
  const int ti = tile / (ntj * ntk), tj = (tile / ntk) % ntj, tk = tile % ntk;
  int total;
  s_next[tid] = base + block_exclusive_scan<kWarps>(
                           counts[cell_index(ti, tj, tk, tid, J, K)], s_warp,
                           &total);
  for (int w = 0; w < kWarps; ++w) s_group[w][tid] = 0;
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  const int c_end = tile_ptr[tile + 1];
  for (int ci = tile_ptr[tile]; ci < c_end; ++ci) {
    const int64_t q = (int64_t)tile_chunks[ci] * kCells + tid;
    const int loc = local_cell(key, covered, q, n, tile);
    // lanes of one cell form a group; a lane that does not take part is a
    // group of its own
    const unsigned group = __match_any_sync(kFull, loc >= 0 ? loc : -1 - lane);
    const int in_group = __popc(group & below);
    const bool leader = loc >= 0 && in_group == 0;
    if (leader) s_group[warp][loc] = __popc(group);
    __syncthreads();
    if (loc >= 0) {
      int at = s_next[loc] + in_group;
      for (int w = 0; w < warp; ++w) at += s_group[w][loc];
      order[at] = (int)q;
    }
    __syncthreads();
    if (leader) {
      s_group[warp][loc] = 0;
      atomicAdd(&s_next[loc], __popc(group));  // a sum: order-free
    }
    __syncwarp();
  }
}

// The ordered stream as sum_cells reads it: particle p of the run is stream
// element order[p]; its rank is p less its cell's start, which lane i of the
// warp holds for the warp's cell i.
struct OrderedStream {
  const float* __restrict__ pos;
  const float* __restrict__ vel;
  const int* __restrict__ key;
  const int* __restrict__ order;
  int end, t0, start_i;
  float x = 0.f, y = 0.f, z = 0.f, vx = 0.f, vy = 0.f, vz = 0.f;
  int k = 0;

  __device__ __forceinline__ void load(int p) {
    if (p < end) {
      const int64_t q = order[p];
      x = pos[3 * q], y = pos[3 * q + 1], z = pos[3 * q + 2];
      vx = vel[3 * q], vy = vel[3 * q + 1], vz = vel[3 * q + 2];
      k = key[q];
    }
  }
  __device__ __forceinline__ Particle next(int p) const {
    const int i = k - t0;
    return Particle{x, y, z, vx, vy, vz, i,
                    p - __shfl_sync(kFull, start_i, i & 31)};
  }
};

template <int kStride, int kTerms>
__global__ void __launch_bounds__(kThreads, 2) stale_sums_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const int* __restrict__ key, const int* __restrict__ order,
    const int* __restrict__ tile_off, const int* __restrict__ counts, int J,
    int K, int cap, float dx, float c1, float c2, float c3, float r2,
    float* __restrict__ sums, float* __restrict__ table) {
  __shared__ float4 s_batch[kWarps][32][2];
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const int ntj = J / 8, ntk = K / 8;
  const int ti = tile / (ntj * ntk), tj = (tile / ntk) % ntj, tk = tile % ntk;
  const int base = tile_off[tile];
  // thread tid is local cell tid: lane i of warp w is the warp's cell i
  int start_i = base, cnt = 0;
  if (tile_off[tile + 1] > base) {  // the same in the whole block
    int total;
    cnt = counts[cell_index(ti, tj, tk, tid, J, K)];
    start_i = base + block_exclusive_scan<kWarps>(cnt, s_warp, &total);
  }
  const int start = __shfl_sync(kFull, start_i, 0);
  const int end = __shfl_sync(kFull, start_i + cnt, 31);
  const int gi = ti * 8 + (warp >> 1);
  const int gj0 = tj * 8 + (warp & 1) * 4;
  const int gk0 = tk * 8;

  OrderedStream src{pos, vel, key, order, end, tile * kCells + warp * 32,
                    start_i};
  const CellRows<kStride, kTerms> out{
      sums, reinterpret_cast<float4*>(table),
      ((int64_t)gi * J + gj0) * K + gk0, K, cap};
  sum_cells<kTerms>(src, out, s_batch[warp], start, end, gi, gj0, gk0, cap,
                    dx, c1, c2, c3, r2);
}

template <int kStride>
decltype(&stale_sums_kernel<kStride, 3>) sums_kernel_of(int terms) {
  if (terms == 1) return stale_sums_kernel<kStride, 1>;
  if (terms == 2) return stale_sums_kernel<kStride, 2>;
  if (terms == 3) return stale_sums_kernel<kStride, 3>;
  return nullptr;
}

}  // namespace

// order: (n,) int32 and tile_off: (n_tiles + 1,) int32 are scratch.
extern "C" int flip3d_p2g_scatter_stale(
    const float* pos, const float* vel, const int* key,
    const unsigned char* covered, int n, const int* tile_ptr,
    const int* tile_chunks, int I, int J, int K, int cap, float dx, float c1,
    float c2, float c3, float r2, int sum_stride, int terms, float* sums,
    float* table, int* counts, int* order, int* tile_off, void* stream) {
  decltype(&stale_sums_kernel<108, 3>) sums_kernel = nullptr;
  if (sum_stride == 108) sums_kernel = sums_kernel_of<108>(terms);
  if (sum_stride == 112) sums_kernel = sums_kernel_of<112>(terms);
  if (sums_kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)(((int64_t)I * J * K) / kCells);
  const cudaStream_t s = (cudaStream_t)stream;
  stale_count_kernel<<<n_tiles, kThreads, 0, s>>>(
      key, covered, n, tile_ptr, tile_chunks, J, K, counts, tile_off);
  stale_scan_kernel<<<1, kScanThreads, 0, s>>>(tile_off, n_tiles);
  stale_place_kernel<<<n_tiles, kThreads, 0, s>>>(
      key, covered, n, tile_ptr, tile_chunks, J, K, counts, tile_off, order);
  sums_kernel<<<n_tiles, kThreads, 0, s>>>(pos, vel, key, order, tile_off,
                                           counts, J, K, cap, dx, c1, c2, c3,
                                           r2, sums, table);
  return (int)cudaGetLastError();
}
