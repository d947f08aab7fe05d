// P2G scatter: per-cell Wyvill weight / momentum sums and the liquid-SDF
// slot table, from particles sorted by tile-major home-cell key.
//
// Replaces flipviscosity3d_tpu/ops/pallas_particles.py::scatter_p2g_table
// (bodies _p2g_chunk_values and _table_chunk_values), the sorted-stream
// form (inkernel_rank=False, fold_sums=False).
//
// Output per cell (standard i-major layout):
//   sums[cell, l]      l < 54: sum of Wyvill weights of window face l
//   sums[cell, 54 + l]         sum of weight * velocity component
//   table[cell, r, :]  (px, py, pz, 1) of the particle of in-cell rank r < cap,
//                      zero for an empty slot
// with lane l = comp*18 + oidx over the 2x3x3 face window of each MAC
// component (p2g_abs_offset). Every output element is written.
//
// What bounds it on the H100: bytes. The sums are 432 B per cell (0.9 GB at
// 128^3) against 24 B per particle read, and ~20 flops per (particle, face).
// The TPU kernel turned the scatter into one-hot MXU matmuls over visit
// plans; here the sort already makes each cell's particles one contiguous
// run, so one warp owns one cell: lane 0 finds the run by two binary
// searches of the sorted keys, all lanes walk it in order (broadcast loads),
// each lane accumulates its <= 2 window faces in registers and its <= 4
// table values, and the warp writes the cell's 108 sums and cap*4 table
// values contiguously. No atomics, a deterministic order (the sorted order),
// and empty cells are zero-filled by the same write. The weight expression
// is _p2g_chunk_values' own, operation by operation (the library is built
// with -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;          // warps (cells) per block
constexpr int kSlotsPerLane = 4;   // cap <= 32: cap*4 <= 128 table values

__device__ __forceinline__ int lower_bound(const int* __restrict__ key, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Window face l (< 54): absolute offset a and the component frame's half-cell
// shift s (0 on the component axis, 0.5 across it), as _p2g_chunk_values.
struct Face {
  float ax, ay, az, sx, sy, sz;
  int comp;
};

__device__ __forceinline__ Face face_of(int l) {
  const int comp = l / 18, oidx = l % 18;
  const float ox = (float)(oidx / 9);
  const float oy = (float)((oidx / 3) % 3 - 1);
  const float oz = (float)(oidx % 3 - 1);
  Face f;
  f.comp = comp;
  f.ax = comp == 0 ? ox : oy;
  f.ay = comp == 0 ? oy : (comp == 1 ? ox : oz);
  f.az = comp == 2 ? ox : oz;
  f.sx = comp == 0 ? 0.f : 0.5f;
  f.sy = comp == 1 ? 0.f : 0.5f;
  f.sz = comp == 2 ? 0.f : 0.5f;
  return f;
}

__device__ __forceinline__ float wyvill(const Face& f, float gi, float gj,
                                        float gk, float px, float py, float pz,
                                        float dx, float c1, float c2, float c3,
                                        float r2) {
  const float fx = (gi + f.ax) * dx - (px - f.sx * dx);
  const float fy = (gj + f.ay) * dx - (py - f.sy * dx);
  const float fz = (gk + f.az) * dx - (pz - f.sz * dx);
  const float d2 = fx * fx + fy * fy + fz * fz;
  const float w = 1.0f - c1 * d2 * d2 * d2 + c2 * d2 * d2 - c3 * d2;
  return d2 < r2 ? w : 0.f;
}

__global__ void p2g_scatter_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ vel,
                                   const int* __restrict__ key,
                                   const int* __restrict__ rank, int n, int I,
                                   int J, int K, int cap, float dx, float c1,
                                   float c2, float c3, float r2,
                                   float* __restrict__ sums,
                                   float* __restrict__ table) {
  const int lane = threadIdx.x & 31;
  const int64_t cell_t =
      (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);  // tile-major key
  const int64_t n_cells = (int64_t)I * J * K;
  if (cell_t >= n_cells) return;
  const int t = (int)cell_t;

  const int ntj = J / 8, ntk = K / 8;
  const int tile = t >> 9, local = t & 511;
  const int gi = (tile / (ntj * ntk)) * 8 + (local >> 6);
  const int gj = ((tile / ntk) % ntj) * 8 + ((local >> 3) & 7);
  const int gk = (tile % ntk) * 8 + (local & 7);
  const int64_t cell = ((int64_t)gi * J + gj) * K + gk;

  int start = 0, end = 0;
  if (lane == 0) {
    start = lower_bound(key, n, t);
    end = lower_bound(key, n, t + 1);
  }
  start = __shfl_sync(kFull, start, 0);
  end = __shfl_sync(kFull, end, 0);

  const bool has2 = lane + 32 < 54;
  const Face f0 = face_of(lane);
  const Face f1 = face_of(has2 ? lane + 32 : lane);
  const float fgi = (float)gi, fgj = (float)gj, fgk = (float)gk;
  float w0 = 0.f, wv0 = 0.f, w1 = 0.f, wv1 = 0.f;
  float slot[kSlotsPerLane];
#pragma unroll
  for (int s = 0; s < kSlotsPerLane; ++s) slot[s] = 0.f;

  for (int q = start; q < end; ++q) {
    const float px = pos[3 * (int64_t)q], py = pos[3 * (int64_t)q + 1],
                pz = pos[3 * (int64_t)q + 2];
    const float vx = vel[3 * (int64_t)q], vy = vel[3 * (int64_t)q + 1],
                vz = vel[3 * (int64_t)q + 2];
    const float v0 = f0.comp == 0 ? vx : (f0.comp == 1 ? vy : vz);
    const float v1 = f1.comp == 0 ? vx : (f1.comp == 1 ? vy : vz);
    const float a = wyvill(f0, fgi, fgj, fgk, px, py, pz, dx, c1, c2, c3, r2);
    w0 = w0 + a;
    wv0 = wv0 + a * v0;
    if (has2) {
      const float b =
          wyvill(f1, fgi, fgj, fgk, px, py, pz, dx, c1, c2, c3, r2);
      w1 = w1 + b;
      wv1 = wv1 + b * v1;
    }
    const int rk = rank[q];
#pragma unroll
    for (int s = 0; s < kSlotsPerLane; ++s) {
      const int e = lane + 32 * s;  // table value index r*4 + f
      if (e < cap * 4 && (e >> 2) == rk) {
        const int c = e & 3;
        slot[s] = c == 0 ? px : (c == 1 ? py : (c == 2 ? pz : 1.0f));
      }
    }
  }

  float* out = sums + cell * 108;
  out[lane] = w0;
  out[54 + lane] = wv0;
  if (has2) {
    out[lane + 32] = w1;
    out[54 + lane + 32] = wv1;
  }
  float* tout = table + cell * (int64_t)cap * 4;
#pragma unroll
  for (int s = 0; s < kSlotsPerLane; ++s) {
    const int e = lane + 32 * s;
    if (e < cap * 4) tout[e] = slot[s];
  }
}

}  // namespace

extern "C" int flip3d_p2g_scatter(const float* pos, const float* vel,
                                  const int* key, const int* rank, int n,
                                  int I, int J, int K, int cap, float dx,
                                  float c1, float c2, float c3, float r2,
                                  float* sums, float* table, void* stream) {
  const int64_t n_cells = (int64_t)I * J * K;
  const unsigned blocks = (unsigned)((n_cells + kWarps - 1) / kWarps);
  p2g_scatter_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      pos, vel, key, rank, n, I, J, K, cap, dx, c1, c2, c3, r2, sums, table);
  return (int)cudaGetLastError();
}
