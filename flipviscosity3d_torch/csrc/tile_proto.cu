// The round-1 prototype's two tile kernels, over a particle payload sorted
// by tile-major cell key: (8, L) float32 rows [px, py, pz, vx, vy, vz, key,
// rank], key and rank held as floats (exact below 2^24), key -1 in the pad
// lanes.
//
//   tile_scatter (K11): per cell of every 8x8x8 tile, one output row of
//     108 + 4 * cap floats: lanes q = comp * 18 + oidx (q < 54) hold the
//     sum of the Wyvill weights of the cell's particles at face offset
//     (ox, oy, oz) = (oidx / 9, (oidx / 3) % 3 - 1, oidx % 3 - 1), the
//     first axis being the component's own, lanes 54 + q the sums of
//     weight * velocity component, and lanes 108 + 4 r + f the sum of
//     [px, py, pz, 1][f] over the cell's particles of rank r < cap (a
//     particle's own values: ranks are unique in a cell). A cell without
//     particles, or a slot without one, is zero.
//   tile_gather (K12): out[p, :] = cols[key_p, :], the per-cell row of
//     stacked columns (n_blocks * 512, F) that particle p's key names; a
//     pad lane (key < 0) gives a zero row.
//
// Replace scripts/pallas_particle_proto.py::make_scatter_kernel and
// ::make_gather_kernel, which ran one grid step per tile (scatter) or per
// chunk of 512 particles (gather) and contracted a (512, C) one-hot of the
// chunk's keys with the particles' values (or the tile's columns) on the
// MXU, accumulating over the chunks (tiles) the block spans.
//
// What bounds them on the H100: bytes. K11 writes every cell's row, empty
// or not (at 128^3 and cap 16, 2,097,152 rows of 172 floats, 1.44 GB,
// against a 0.14 GB payload); K12 writes a 128-float row per lane (2.28 GB
// at 128^3) from 0.29 GB of distinct cell rows.
//
// K11: the sort makes each cell's particles one contiguous run, so K11 is
// K1's structure (p2g_scatter.cu): a warp owns 32 consecutive cells of a
// tile, finds their whole run inside the tile's [starts[b], starts[b+1])
// by two 32-lane searches of the float keys (warp_lower_bound), and sums it
// by the walk of p2g_cells.cuh (32 particles a batch, the next in flight;
// lane l on faces l and l + 32 in registers; a cell closed where the key
// changes). A particle of rank r < cap writes its own slot, lanes
// 108 + 4r .. 108 + 4r + 3, as one float4 when it is loaded; a closed
// cell's 108 sums go through the warp's row of shared memory and out as 27
// float4, its empty slots as float4 zeros, and an empty cell's whole row as
// float4 zeros. No atomics: every sum runs in stream order from zero, as
// the warp-per-cell kernel this replaces ran it, so the rows are bit for
// bit the same and do not vary from call to call.
//
// K12: one warp per output row copies F contiguous floats, as float4 where
// F is a multiple of 4. A copy, so the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "p2g_cells.cuh"
#include "sorted_runs.cuh"

namespace {

using flip3d::LaneFaces;
using flip3d::Particle;
using flip3d::sum_cells;
using flip3d::warp_lower_bound;

constexpr int kW = 512;      // cells per 8x8x8 tile
constexpr int kSums = 108;   // 54 weights + 54 weight * velocity
constexpr int kWarps = 8;    // warps (32 cells or one row) per block

// The payload's rows as sum_cells reads them: particle p of the run is lane
// p of [px, py, pz, vx, vy, vz, key, rank].
struct PayloadRows {
  const float* __restrict__ payload;
  int64_t lanes;
  int end, t0;
  float x = 0.f, y = 0.f, z = 0.f, vx = 0.f, vy = 0.f, vz = 0.f, k = 0.f,
        r = 0.f;

  __device__ __forceinline__ void load(int p) {
    if (p < end) {
      x = payload[p], y = payload[lanes + p], z = payload[2 * lanes + p];
      vx = payload[3 * lanes + p], vy = payload[4 * lanes + p];
      vz = payload[5 * lanes + p];
      k = payload[6 * lanes + p], r = payload[7 * lanes + p];
    }
  }
  __device__ __forceinline__ Particle next(int) const {
    return Particle{x, y, z, vx, vy, vz, (int)k - t0, (int)r};
  }
};

// K11's output: cell t0 + i's row of 108 + 4 cap floats, written as float4;
// `row` is the warp's 108 floats of shared memory.
struct ProtoRows {
  float* __restrict__ out;
  float* __restrict__ row;
  int64_t t0;
  int n4, cap;  // float4 per row, slots

  __device__ __forceinline__ float4* row4(int i) const {
    return reinterpret_cast<float4*>(out + (t0 + i) * (4 * (int64_t)n4));
  }
  // a particle's own values, as the one-hot table sum of the replaced
  // kernel (0 + x) holds them
  __device__ __forceinline__ void slot(const Particle& pt) const {
    row4(pt.i)[kSums / 4 + pt.r] =
        make_float4(0.f + pt.x, 0.f + pt.y, 0.f + pt.z, 1.0f);
  }
  __device__ __forceinline__ void close(int i, int count,
                                        const LaneFaces<3>& lf) const {
    const int lane = threadIdx.x & 31;
    row[lane] = lf.w0.total();
    row[54 + lane] = lf.wv0.total();
    if (lane + 32 < 54) {
      row[lane + 32] = lf.w1.total();
      row[54 + lane + 32] = lf.wv1.total();
    }
    __syncwarp();
    float4* dst = row4(i);
    if (lane < kSums / 4) dst[lane] = reinterpret_cast<const float4*>(row)[lane];
    if (lane >= count && lane < cap)
      dst[kSums / 4 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
  }
  __device__ __forceinline__ void zero(int i) const {
    float4* dst = row4(i);
    for (int e = threadIdx.x & 31; e < n4; e += 32)
      dst[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

__global__ void __launch_bounds__(kWarps * 32, 4)
    tile_scatter_kernel(const int* __restrict__ starts,
                        const float* __restrict__ payload, int64_t lanes,
                        int n_blocks, int nt1, int nt2, float dx, float r2,
                        float c1, float c2, float c3, int cap,
                        float* __restrict__ out) {
  __shared__ float4 s_batch[kWarps][32][2];
  __shared__ __align__(16) float s_row[kWarps][kSums];
  const int warp = threadIdx.x >> 5;
  const int64_t first = ((int64_t)blockIdx.x * kWarps + warp) * 32;
  if (first >= (int64_t)n_blocks * kW) return;
  const int t0 = (int)first;
  const int b = t0 / kW, l0 = t0 % kW;
  const float* __restrict__ key = payload + 6 * lanes;
  int start = starts[b], end = starts[b + 1];
  if (start < end) {  // the same in every lane
    start = warp_lower_bound(key, start, end, (float)t0);
    end = warp_lower_bound(key, start, end, (float)(t0 + 32));
  }
  const int ti = b / (nt1 * nt2), tj = (b / nt2) % nt1, tk = b % nt2;
  const int gi = ti * 8 + l0 / 64;
  const int gj0 = tj * 8 + (l0 / 8) % 8;
  const int gk0 = tk * 8;

  PayloadRows src{payload, lanes, end, t0};
  const ProtoRows rows{out, s_row[warp], t0, kSums / 4 + cap, cap};
  sum_cells<3>(src, rows, s_batch[warp], start, end, gi, gj0, gk0, cap, dx,
               c1, c2, c3, r2);
}

// V: float or float4; f is F in units of V.
template <typename V>
__global__ void tile_gather_kernel(const float* __restrict__ key,
                                   int64_t n_rows, const V* __restrict__ cols,
                                   int f, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n_rows) return;
  V* __restrict__ dst = out + p * f;
  const float k = key[p];
  if (k >= 0.0f) {
    const V* __restrict__ src = cols + (int64_t)k * f;
    for (int e = lane; e < f; e += 32) dst[e] = src[e];
  } else {
    const V zero = V();
    for (int e = lane; e < f; e += 32) dst[e] = zero;
  }
}

}  // namespace

extern "C" int flip3d_tile_scatter(const int* starts, const float* payload,
                                   int64_t lanes, int n_blocks, int nt1,
                                   int nt2, float dx, float r2, float c1,
                                   float c2, float c3, int cap, float* out,
                                   void* stream) {
  if (n_blocks == 0) return 0;
  const int64_t cells = (int64_t)n_blocks * kW;  // 32 a warp
  const unsigned blocks =
      (unsigned)((cells + kWarps * 32 - 1) / (kWarps * 32));
  tile_scatter_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      starts, payload, lanes, n_blocks, nt1, nt2, dx, r2, c1, c2, c3, cap,
      out);
  return (int)cudaGetLastError();
}

extern "C" int flip3d_tile_gather(const float* key, int64_t n_rows,
                                  const float* cols, int F, float* out,
                                  void* stream) {
  if (n_rows == 0 || F == 0) return 0;
  const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (F % 4 == 0)
    tile_gather_kernel<float4><<<blocks, kWarps * 32, 0, s>>>(
        key, n_rows, (const float4*)cols, F / 4, (float4*)out);
  else
    tile_gather_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        key, n_rows, cols, F, out);
  return (int)cudaGetLastError();
}
