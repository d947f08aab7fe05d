// Per-particle rows of an F-major tile image:
//   rows[p, f] = cols[key_p / 512, f, key_p % 512]   for f < f_logical,
// zero rows for uncovered particles. The image is (n_tiles, f_stride, 512),
// f32 or bf16 (a bf16 value is widened exactly); rows are (N, f_logical)
// f32; lanes >= f_logical of the image are never read.
//
// Replaces flipviscosity3d_tpu/ops/pallas_particles.py::gather_rows, which
// walked a visit plan of (chunk, tile) pairs and contracted a (512, C)
// one-hot of the chunk's localised keys with the tile's (F, 512) block on
// the MXU, accumulating 128-lane output rows over the chunk's visits.
//
// What bounds it on the H100: bytes, and among them the access pattern. One
// particle's row is f_logical reads 2 KB apart (1 KB in bf16), while its
// output row is contiguous. A block takes a run of 32 particles. Each warp
// takes every 8th lane f and reads the 32 particles' values of that lane,
// one particle per thread: in a sorted stream the 32 particles sit in a few
// neighbouring cells of one tile, so a warp's load touches a few 32 B
// sectors (an 8-cell k run of one lane is one sector). The 32 x f_logical
// values are turned through shared memory (row f padded to 33 words, so the
// transposed reads hit 32 banks) and written as one contiguous, coalesced
// run of 32 * f_logical floats. Keys need not be sorted: an unsorted stream
// only spreads each warp's load over up to 32 sectors. Offsets are int64
// (the image passes 2^31 bytes at 256^3). A copy, so the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParticles = 32;   // particles per block
constexpr int kWarps = 8;
constexpr int kW = 512;          // cells per tile
constexpr int kPad = kParticles + 1;

__device__ __forceinline__ float widen(float v) { return v; }
// bf16 bits are the upper half of the f32 of the same value
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}

template <typename T>
__global__ void gather_rows_kernel(const int* __restrict__ key,
                                   const unsigned char* __restrict__ covered,
                                   int n, const T* __restrict__ cols,
                                   int f_stride, int f_logical,
                                   float* __restrict__ rows) {
  extern __shared__ float tile[];   // [f_logical][kPad]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p0 = (int64_t)blockIdx.x * kParticles;
  const int64_t p = p0 + lane;
  bool live = p < n;
  int64_t base = 0;
  if (live) {
    live = covered == nullptr || covered[p] != 0;
    const int t = key[p];
    base = (int64_t)(t >> 9) * f_stride * kW + (t & (kW - 1));
  }
  for (int f = warp; f < f_logical; f += kWarps)
    tile[f * kPad + lane] = live ? widen(cols[base + (int64_t)f * kW]) : 0.f;
  __syncthreads();
  const int64_t left = n - p0;
  const int count = (left < kParticles ? (int)left : kParticles) * f_logical;
  float* __restrict__ out = rows + p0 * f_logical;
  for (int e = threadIdx.x; e < count; e += kWarps * 32) {
    const int q = e / f_logical, f = e - q * f_logical;
    out[e] = tile[f * kPad + q];
  }
}

}  // namespace

// is_bf16: 0 for an f32 image, 1 for a bf16 one. covered may be null (every
// particle covered).
extern "C" int flip3d_gather_rows(const int* key, const unsigned char* covered,
                                  int n, const void* cols, int is_bf16,
                                  int f_stride, int f_logical, float* rows,
                                  void* stream) {
  if (n == 0 || f_logical == 0) return 0;
  const unsigned blocks = (unsigned)(((int64_t)n + kParticles - 1) / kParticles);
  const size_t smem = (size_t)f_logical * kPad * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    gather_rows_kernel<unsigned short>
        <<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
            key, covered, n, (const unsigned short*)cols, f_stride, f_logical,
            rows);
  else
    gather_rows_kernel<float>
        <<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
            key, covered, n, (const float*)cols, f_stride, f_logical, rows);
  return (int)cudaGetLastError();
}
