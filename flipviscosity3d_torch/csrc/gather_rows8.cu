// Node-SDF corner gather of the solid pushback: the 8 node values
// phi_node[i + a, j + b, k + c], (a, b, c) in NODE_CORNERS order
// (itertools.product((0, 1), repeat=3), row f = 4a + 2b + c), of each
// covered particle's tile-major home cell; zero rows for uncovered
// particles.
//
// Replaces flipviscosity3d_tpu/ops/pallas_particles.py::gather_rows8, which
// read pack_cols8(stack_tile_major(node_corner_columns(phi))) through a
// visit plan: 16 cells' 8-lane rows folded into one 128-lane row so its DMA
// moved no padding, then a row one-hot and a lane select on the MXU.
//
// What bounds it on the H100: bytes. Per particle it reads a 4 B key and a
// 1 B coverage flag and writes 32 B; the node grid (9 MB at 128^3) stays in
// the 50 MB L2. No column image is built: one thread per particle decodes its
// key and reads the 8 corners straight from phi_node; the output rows are
// (8, N), so each of the 8 stores of a warp is coalesced along N. A copy, so
// the result is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows8_kernel(const int* __restrict__ key,
                                    const unsigned char* __restrict__ covered,
                                    int n, const float* __restrict__ phi,
                                    int I, int J, int K,
                                    float* __restrict__ out) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float v[8];
#pragma unroll
  for (int f = 0; f < 8; ++f) v[f] = 0.f;
  if (covered[q]) {
    const int t = key[q];
    const int ntj = J / 8, ntk = K / 8;
    const int tile = t >> 9, local = t & 511;
    const int i = (tile / (ntj * ntk)) * 8 + (local >> 6);
    const int j = ((tile / ntk) % ntj) * 8 + ((local >> 3) & 7);
    const int k = (tile % ntk) * 8 + (local & 7);
    const int64_t sj = K + 1, si = (int64_t)(J + 1) * (K + 1);
    const float* __restrict__ base = phi + i * si + j * sj + k;
#pragma unroll
    for (int f = 0; f < 8; ++f)
      v[f] = base[(f >> 2) * si + ((f >> 1) & 1) * sj + (f & 1)];
  }
#pragma unroll
  for (int f = 0; f < 8; ++f) out[(int64_t)f * n + q] = v[f];
}

}  // namespace

extern "C" int flip3d_gather_rows8(const int* key, const unsigned char* covered,
                                   int n, const float* phi, int I, int J,
                                   int K, float* out, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  gather_rows8_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key, covered, n, phi, I, J, K, out);
  return (int)cudaGetLastError();
}
