// Tile-major to standard layout: y (n_tiles, 512, F) -> out (I, J, K, F),
//   out[i, j, k, :] = y[tile(i, j, k), local(i, j, k), :]
// with 8x8x8 tiles, tile = ((i/8) * (J/8) + j/8) * (K/8) + k/8 and
// local = ((i%8) * 8 + j%8) * 8 + k%8.
//
// Replaces flipviscosity3d_tpu/ops/pallas_particles.py::detile, a Pallas
// block copy with one grid step per tile (the tile's (512, F) rows in, the
// (8, 8, 8, F) cube out through the BlockSpec index maps).
//
// What bounds it on the H100: bytes, each read once and written once. The
// 8 cells of a k run are 8*F contiguous floats on both sides, and the 64
// cells of one i-plane of a tile are 64*F contiguous floats of the source.
// One block copies one (tile, i-plane): it reads its 64*F floats in order
// and writes them as 8 runs of 8*F floats, K*F apart. Both sides are
// coalesced. Where F is a multiple of 4 (or 2) every run starts on a 16 B
// (8 B) boundary and the copy moves float4 (float2); any other F (F = 3)
// copies float by float. Offsets are int64. A copy, so the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// V: float, float2 or float4; f is F in units of V.
template <typename V>
__global__ void detile_kernel(const V* __restrict__ y, int J, int K, int f,
                              V* __restrict__ out) {
  const int ntj = J / 8, ntk = K / 8;
  const int tile = blockIdx.x >> 3, li = blockIdx.x & 7;
  const int i = (tile / (ntj * ntk)) * 8 + li;
  const int j0 = ((tile / ntk) % ntj) * 8;
  const int k0 = (tile % ntk) * 8;
  const V* __restrict__ src = y + ((int64_t)tile * 512 + li * 64) * f;
  V* __restrict__ dst = out + (((int64_t)i * J + j0) * K + k0) * f;
  const int run = 8 * f;                 // one k run, in V
  const int64_t row = (int64_t)K * f;    // from one j to the next, in V
  for (int e = threadIdx.x; e < 8 * run; e += kThreads) {
    const int lj = e / run;
    dst[lj * row + (e - lj * run)] = src[e];
  }
}

template <typename V>
int launch(const float* y, int n_tiles, int J, int K, int f, float* out,
           cudaStream_t stream) {
  detile_kernel<V><<<(unsigned)n_tiles * 8, kThreads, 0, stream>>>(
      (const V*)y, J, K, f, (V*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flip3d_detile(const float* y, int I, int J, int K, int F,
                             float* out, void* stream) {
  const int n_tiles = (I / 8) * (J / 8) * (K / 8);
  if (n_tiles == 0 || F == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (F % 4 == 0) return launch<float4>(y, n_tiles, J, K, F / 4, out, s);
  if (F % 2 == 0) return launch<float2>(y, n_tiles, J, K, F / 2, out, s);
  return launch<float>(y, n_tiles, J, K, F, out, s);
}
