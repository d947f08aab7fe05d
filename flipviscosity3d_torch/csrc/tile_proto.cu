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
// K11: the sort makes each cell's particles one contiguous run, so one warp
// owns one cell, as in p2g_scatter.cu: lane 0 finds the run inside its
// tile's [starts[b], starts[b+1]) by two binary searches of the float keys
// (none for an empty tile), the warp walks it in stream order with each
// lane owning two of the 54 (component, offset) pairs and four table
// lanes, and writes the cell's whole row. No atomics: every sum runs in
// stream order from zero, the same in every call.
//
// K12: one warp per output row copies F contiguous floats, as float4 where
// F is a multiple of 4. A copy, so the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 512;      // cells per 8x8x8 tile
constexpr int kPairs = 54;   // (component, face offset) pairs
constexpr int kSums = 2 * kPairs;
constexpr int kWarps = 8;    // warps (cells or rows) per block
constexpr unsigned kFull = 0xffffffffu;

// First index in key[lo, hi) whose value is not below v.
__device__ __forceinline__ int lower_bound_f(const float* __restrict__ key,
                                             int lo, int hi, float v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void tile_scatter_kernel(const int* __restrict__ starts,
                                    const float* __restrict__ payload,
                                    int64_t lanes, int n_blocks, int nt1,
                                    int nt2, float dx, float r2, float c1,
                                    float c2, float c3, int cap,
                                    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t cell = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cell >= (int64_t)n_blocks * kW) return;
  const int n_cols = kSums + 4 * cap;
  const int b = (int)(cell / kW);
  const int l = (int)(cell % kW);
  const float* __restrict__ key = payload + 6 * lanes;
  const float* __restrict__ rank = payload + 7 * lanes;

  int start = 0, end = 0;
  const int s0 = starts[b], s1 = starts[b + 1];
  if (lane == 0 && s0 < s1) {
    start = lower_bound_f(key, s0, s1, (float)cell);
    end = lower_bound_f(key, start, s1, (float)(cell + 1));
  }
  start = __shfl_sync(kFull, start, 0);
  end = __shfl_sync(kFull, end, 0);

  // the cell's integer coordinates, as floats
  const int ti = b / (nt1 * nt2), tj = (b / nt2) % nt1, tk = b % nt2;
  const float li = (float)(ti * 8 + l / 64);
  const float lj = (float)(tj * 8 + (l / 8) % 8);
  const float lk = (float)(tk * 8 + l % 8);

  // this lane's two pairs: the face's position and the particle shift
  float gx[2], gy[2], gz[2], sx[2], sy[2], sz[2];
  int comp[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lane + 32 * s;
    const int c = q / 18, oidx = q % 18;
    const float ox = (float)(oidx / 9);
    const float oy = (float)((oidx / 3) % 3 - 1);
    const float oz = (float)(oidx % 3 - 1);
    const float ax = c == 0 ? ox : oy;
    const float ay = c == 0 ? oy : (c == 1 ? ox : oz);
    const float az = c == 2 ? ox : oz;
    comp[s] = q < kPairs ? c : -1;
    gx[s] = (li + ax) * dx;
    gy[s] = (lj + ay) * dx;
    gz[s] = (lk + az) * dx;
    sx[s] = (c == 0 ? 0.0f : 0.5f) * dx;
    sy[s] = (c == 1 ? 0.0f : 0.5f) * dx;
    sz[s] = (c == 2 ? 0.0f : 0.5f) * dx;
  }

  float wsum[2] = {0.f, 0.f}, wvsum[2] = {0.f, 0.f};
  float tab[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p = start; p < end; ++p) {
    const float px = payload[p], py = payload[lanes + p];
    const float pz = payload[2 * lanes + p];
    const float vx = payload[3 * lanes + p], vy = payload[4 * lanes + p];
    const float vz = payload[5 * lanes + p];
    const int r = (int)rank[p];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (comp[s] < 0) continue;
      const float fx = gx[s] - (px - sx[s]);
      const float fy = gy[s] - (py - sy[s]);
      const float fz = gz[s] - (pz - sz[s]);
      const float d2 = fx * fx + fy * fy + fz * fz;
      float w = 1.0f - c1 * d2 * d2 * d2 + c2 * d2 * d2 - c3 * d2;
      w = d2 < r2 ? w : 0.0f;
      const float v = comp[s] == 0 ? vx : (comp[s] == 1 ? vy : vz);
      wsum[s] = wsum[s] + w;
      wvsum[s] = wvsum[s] + w * v;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = lane + 32 * t;
      if (j < 4 * cap && j / 4 == r) {
        const int f = j % 4;
        tab[t] = tab[t] + (f == 0 ? px : (f == 1 ? py : (f == 2 ? pz : 1.0f)));
      }
    }
  }

  float* __restrict__ row = out + cell * n_cols;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (comp[s] < 0) continue;
    const int q = lane + 32 * s;
    row[q] = wsum[s];
    row[kPairs + q] = wvsum[s];
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = lane + 32 * t;
    if (j < 4 * cap) row[kSums + j] = tab[t];
  }
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
  const int64_t cells = (int64_t)n_blocks * kW;
  const unsigned blocks = (unsigned)((cells + kWarps - 1) / kWarps);
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
