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
// loads each). It streams the run 32 particles at a time: lane l loads
// particle b + l (coalesced, the next batch in flight while the current one
// is summed), writes its slot-table entry if its rank is below cap, and
// stages it in shared memory; then the warp walks the batch in stream order,
// each particle read by two broadcast 16-byte loads. Lane l owns window
// faces l and l + 32 of the current cell and sums them in registers; where
// the particle's cell changes, the warp writes the finished cell's 108 sums
// and zeroes its empty slots, and writes every empty cell between as a zero
// row and zero slots (float4 stores). Each cell's sums are added in stream
// order with -fmad=false and the weight expression of _p2g_chunk_values, so
// the result is bit for bit that of the warp-per-cell kernel this replaces
// and does not vary from run to run; no atomics, no zero-fill pass. What
// holds it at ~1.6x its bound now is the write stream itself, rows written
// by four scalar stores at ~2.2 TB/s (PERF.md).
//
// The K-folded form (I, J, K*112) of the TPU kernel is a second kernel body
// there (the one-hot splits so that the MXU result is already the folded
// block). Here the fold is only where a cell's row is written: cell * 112 in
// place of cell * 108, with the 4 pad lanes written as zero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "p2g_wyvill.cuh"
#include "sorted_runs.cuh"

namespace {

using flip3d::Face;
using flip3d::face_of;
using flip3d::split_round;
using flip3d::SplitSum;
using flip3d::warp_lower_bound;
using flip3d::wyvill_at;

constexpr int kWarps = 8;    // warps per block
constexpr int kCells = 32;   // consecutive tile-major keys (cells) per warp
constexpr int kLanes = 108;  // sums per cell

// One lane's window faces l and l + 32 of the cell being summed: the parts
// of the weight that do not depend on the particle, and the sums.
template <int kTerms>
struct LaneFaces {
  float a0x, a0y, a0z, s0x, s0y, s0z, a1x, a1y, a1z, s1x, s1y, s1z;
  SplitSum<kTerms> w0, wv0, w1, wv1;
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  const int64_t cell0 = ((int64_t)gi * J + gj0) * K + gk0;
  auto cell_of = [&](int i) {
    return cell0 + (int64_t)(i >> 3) * K + (i & 7);
  };

  const bool has2 = lane + 32 < 54;
  const Face f0 = face_of(lane);
  const Face f1 = face_of(has2 ? lane + 32 : lane);
  float4* table4 = reinterpret_cast<float4*>(table);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  LaneFaces<kTerms> lf;
  lf.s0x = f0.sx * dx, lf.s0y = f0.sy * dx, lf.s0z = f0.sz * dx;
  lf.s1x = f1.sx * dx, lf.s1y = f1.sy * dx, lf.s1z = f1.sz * dx;
  const float fgi = (float)gi;
  auto begin_cell = [&](int i) {
    const float fgj = (float)(gj0 + (i >> 3)), fgk = (float)(gk0 + (i & 7));
    lf.a0x = (fgi + f0.ax) * dx, lf.a0y = (fgj + f0.ay) * dx;
    lf.a0z = (fgk + f0.az) * dx;
    lf.a1x = (fgi + f1.ax) * dx, lf.a1y = (fgj + f1.ay) * dx;
    lf.a1z = (fgk + f1.az) * dx;
    lf.w0 = lf.wv0 = lf.w1 = lf.wv1 = SplitSum<kTerms>();
  };
  // the sums of cell i and its slots [count, cap)
  auto write_cell = [&](int i, int count) {
    const int64_t cell = cell_of(i);
    float* out = sums + cell * kStride;
    out[lane] = lf.w0.total();
    out[54 + lane] = lf.wv0.total();
    if (has2) {
      out[lane + 32] = lf.w1.total();
      out[54 + lane + 32] = lf.wv1.total();
    }
    if (lane < kStride - kLanes) out[kLanes + lane] = 0.f;
    if (lane >= count && lane < cap) table4[cell * cap + lane] = zero4;
  };
  // an empty cell: a zero row and zero slots
  auto zero_cell = [&](int i) {
    const int64_t cell = cell_of(i);
    if (lane < kStride / 4)
      reinterpret_cast<float4*>(sums + cell * kStride)[lane] = zero4;
    if (lane < cap) table4[cell * cap + lane] = zero4;
  };

  int cur = 0, count = 0;  // the cell being summed, its particles so far
  begin_cell(0);
  // lane l's particle of the next batch
  float nx = 0.f, ny = 0.f, nz = 0.f, nvx = 0.f, nvy = 0.f, nvz = 0.f;
  int nk = 0, nr = 0;
  auto load = [&](int q) {
    if (q < end) {
      nx = pos[3 * (int64_t)q], ny = pos[3 * (int64_t)q + 1];
      nz = pos[3 * (int64_t)q + 2];
      nvx = vel[3 * (int64_t)q], nvy = vel[3 * (int64_t)q + 1];
      nvz = vel[3 * (int64_t)q + 2];
      nk = key[q], nr = rank[q];
    }
  };
  load(start + lane);
  for (int b = start; b < end; b += 32) {
    if (b + lane < end) {
      if (nr < cap)
        table4[cell_of(nk - t0) * cap + nr] =
            make_float4(split_round<kTerms>(nx), split_round<kTerms>(ny),
                        split_round<kTerms>(nz), 1.0f);
      s_batch[warp][lane][0] = make_float4(nx, ny, nz, nvx);
      s_batch[warp][lane][1] = make_float4(nvy, nvz, __int_as_float(nk - t0),
                                           0.f);
    }
    __syncwarp();
    load(b + 32 + lane);  // in flight while this batch is summed
    const int nb = min(32, end - b);
    for (int j = 0; j < nb; ++j) {
      const float4 pa = s_batch[warp][j][0], pb = s_batch[warp][j][1];
      const int i = __float_as_int(pb.z);
      if (i != cur) {  // the same in every lane
        write_cell(cur, count);
        for (int e = cur + 1; e < i; ++e) zero_cell(e);
        cur = i;
        count = 0;
        begin_cell(i);
      }
      ++count;
      const float px = pa.x, py = pa.y, pz = pa.z;
      const float v0 = f0.comp == 0 ? pa.w : (f0.comp == 1 ? pb.x : pb.y);
      const float v1 = f1.comp == 0 ? pa.w : (f1.comp == 1 ? pb.x : pb.y);
      const float a = wyvill_at(lf.a0x, lf.a0y, lf.a0z, lf.s0x, lf.s0y,
                                lf.s0z, px, py, pz, c1, c2, c3, r2);
      lf.w0.add(a);
      lf.wv0.add(a * v0);
      if (has2) {
        const float c = wyvill_at(lf.a1x, lf.a1y, lf.a1z, lf.s1x, lf.s1y,
                                  lf.s1z, px, py, pz, c1, c2, c3, r2);
        lf.w1.add(c);
        lf.wv1.add(c * v1);
      }
    }
    __syncwarp();
  }
  write_cell(cur, count);
  for (int e = cur + 1; e < kCells; ++e) zero_cell(e);
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
