// Fused V-cycle level kernels: mg_down and mg_up.
//
// Replaces flipviscosity3d_tpu/ops/pallas_mg.py::down (_down_kernel) and
// ::up (_up_kernel). One level of the V(1,1) cycle of both CG solves is one
// DOWN and one UP launch:
//   DOWN: x = omega*D^-1 b;  r = b - A x;  rc = 2x2x2 sum-pool of r
//   UP:   x2 = x + scale*xc[parent];  out = x2 + omega*D^-1 (b - A x2)
// with A x = diag*x - sum_ax (L_ax*x(+ax) + L_ax(-ax)*x(-ax)), zero out of
// range, on the level's real (nb, I, J, K) shape.
//
// What bounds it on the H100: memory traffic. Per fine cell the kernels do
// ~20 flops against 4 operator values (bf16: 8 bytes, f32: 16) plus b and x
// (4-8 bytes), far below the card's ~20 flops/byte balance point. The TPU
// kernel blocked BI rows in VMEM with halo row blocks; here every thread
// reads its neighbours straight from device memory and relies on L1/L2 for
// the ~6x reuse. The operator is stored in bf16 by default (template on the
// storage type) to halve its share of the traffic, and upcast before any
// arithmetic. DOWN runs one thread per coarse cell: x = omega*D^-1 b is
// pointwise, so the thread recomputes the neighbours' x from b and diag,
// forms r at its 8 fine cells and pools them itself, with no atomics and no
// second pass. UP runs one thread per fine cell and recomputes the
// neighbours' x2 from x and their parents' xc. A simple first version: no
// shared-memory tiling yet.
//
// Summation order follows the JAX expression (i-pairs, then j, then k for
// the pool; the six link terms in i, j, k order), and the library is built
// with -fmad=false, so results differ from the plain PyTorch version only
// where the operator's own rounding differs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float ld(const T* p, int64_t i);
template <>
__device__ __forceinline__ float ld<float>(const float* p, int64_t i) {
  return p[i];
}
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p,
                                                   int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float inv_diag(float d) {
  return d > 0.f ? 1.0f / d : 0.f;
}

template <typename T>
struct Level {
  const T* d;
  const T* l0;
  const T* l1;
  const T* l2;
  const float* b;
  int I, J, K;
  int64_t base;  // offset of this batch entry

  __device__ __forceinline__ bool in(int i, int j, int k) const {
    return i >= 0 && i < I && j >= 0 && j < J && k >= 0 && k < K;
  }
  __device__ __forceinline__ int64_t at(int i, int j, int k) const {
    return base + ((int64_t)i * J + j) * K + k;
  }
};

// x of the DOWN pre-smooth from zero: omega*D^-1 b (0 out of range).
template <typename T>
struct XDown {
  const Level<T>& L;
  float omega;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    if (!L.in(i, j, k)) return 0.f;
    int64_t c = L.at(i, j, k);
    return (omega * inv_diag(ld(L.d, c))) * L.b[c];
  }
};

// x2 of UP: x + scale*xc[parent] (0 out of range).
template <typename T>
struct XUp {
  const Level<T>& L;
  const float* x;
  const float* xc;
  int Jc, Kc;
  int64_t cbase;
  float scale;
  __device__ __forceinline__ float operator()(int i, int j, int k) const {
    if (!L.in(i, j, k)) return 0.f;
    int64_t p = cbase + ((int64_t)(i >> 1) * Jc + (j >> 1)) * Kc + (k >> 1);
    return x[L.at(i, j, k)] + scale * xc[p];
  }
};

// r = b - A x at fine cell (i, j, k), with x given by the functor.
template <typename T, typename XF>
__device__ __forceinline__ float residual(const Level<T>& L, const XF& xf,
                                          int i, int j, int k, float xc) {
  const int64_t c = L.at(i, j, k);
  const int64_t si = (int64_t)L.J * L.K, sj = L.K;
  float y = ld(L.d, c) * xc;
  if (i + 1 < L.I) y = y - ld(L.l0, c) * xf(i + 1, j, k);
  if (i > 0) y = y - ld(L.l0, c - si) * xf(i - 1, j, k);
  if (j + 1 < L.J) y = y - ld(L.l1, c) * xf(i, j + 1, k);
  if (j > 0) y = y - ld(L.l1, c - sj) * xf(i, j - 1, k);
  if (k + 1 < L.K) y = y - ld(L.l2, c) * xf(i, j, k + 1);
  if (k > 0) y = y - ld(L.l2, c - 1) * xf(i, j, k - 1);
  return L.b[c] - y;
}

template <typename T>
__global__ void mg_down_kernel(const T* __restrict__ d, const T* __restrict__ l0,
                               const T* __restrict__ l1,
                               const T* __restrict__ l2,
                               const float* __restrict__ b, int nb, int I,
                               int J, int K, float omega,
                               float* __restrict__ x_out,
                               float* __restrict__ rc_out) {
  const int Ic = (I + 1) >> 1, Jc = (J + 1) >> 1, Kc = (K + 1) >> 1;
  const int64_t total = (int64_t)nb * Ic * Jc * Kc;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int kc = (int)(t % Kc);
  const int jc = (int)((t / Kc) % Jc);
  const int ic = (int)((t / ((int64_t)Kc * Jc)) % Ic);
  const int bb = (int)(t / ((int64_t)Kc * Jc * Ic));

  Level<T> L{d, l0, l1, l2, b, I, J, K, (int64_t)bb * I * J * K};
  XDown<T> xf{L, omega};

  float r[2][2][2];
#pragma unroll
  for (int di = 0; di < 2; ++di)
#pragma unroll
    for (int dj = 0; dj < 2; ++dj)
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const int i = 2 * ic + di, j = 2 * jc + dj, k = 2 * kc + dk;
        if (L.in(i, j, k)) {
          const float xv = xf(i, j, k);
          x_out[L.at(i, j, k)] = xv;
          r[di][dj][dk] = residual(L, xf, i, j, k, xv);
        } else {
          r[di][dj][dk] = 0.f;
        }
      }
  // pool: i pairs, then j pairs, then k pairs
  float q[2];
#pragma unroll
  for (int dk = 0; dk < 2; ++dk)
    q[dk] = (r[0][0][dk] + r[1][0][dk]) + (r[0][1][dk] + r[1][1][dk]);
  rc_out[t] = q[0] + q[1];
}

template <typename T>
__global__ void mg_up_kernel(const T* __restrict__ d, const T* __restrict__ l0,
                             const T* __restrict__ l1, const T* __restrict__ l2,
                             const float* __restrict__ b,
                             const float* __restrict__ x,
                             const float* __restrict__ xc, int nb, int I,
                             int J, int K, float omega, float scale,
                             float* __restrict__ out) {
  const int Ic = (I + 1) >> 1, Jc = (J + 1) >> 1, Kc = (K + 1) >> 1;
  const int64_t total = (int64_t)nb * I * J * K;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int k = (int)(t % K);
  const int j = (int)((t / K) % J);
  const int i = (int)((t / ((int64_t)K * J)) % I);
  const int bb = (int)(t / ((int64_t)K * J * I));

  Level<T> L{d, l0, l1, l2, b, I, J, K, (int64_t)bb * I * J * K};
  XUp<T> xf{L, x, xc, Jc, Kc, (int64_t)bb * Ic * Jc * Kc, scale};
  const float x2 = xf(i, j, k);
  const float r = residual(L, xf, i, j, k, x2);
  out[t] = x2 + (omega * inv_diag(ld(L.d, t))) * r;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_down(const void* d, const void* l0, const void* l1, const void* l2,
                const float* b, int nb, int I, int J, int K, float omega,
                float* x, float* rc, void* stream) {
  const int64_t total =
      (int64_t)nb * ((I + 1) / 2) * ((J + 1) / 2) * ((K + 1) / 2);
  mg_down_kernel<T><<<blocks_for(total), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const T*)d, (const T*)l0, (const T*)l1, (const T*)l2, b, nb, I, J, K,
      omega, x, rc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_up(const void* d, const void* l0, const void* l1, const void* l2,
              const float* b, const float* x, const float* xc, int nb, int I,
              int J, int K, float omega, float scale, float* out,
              void* stream) {
  const int64_t total = (int64_t)nb * I * J * K;
  mg_up_kernel<T><<<blocks_for(total), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const T*)d, (const T*)l0, (const T*)l1, (const T*)l2, b, x, xc, nb, I,
      J, K, omega, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int flip3d_mg_down_f32(const void* d, const void* l0, const void* l1,
                       const void* l2, const float* b, int nb, int I, int J,
                       int K, float omega, float* x, float* rc,
                       void* stream) {
  return launch_down<float>(d, l0, l1, l2, b, nb, I, J, K, omega, x, rc,
                            stream);
}

int flip3d_mg_down_bf16(const void* d, const void* l0, const void* l1,
                        const void* l2, const float* b, int nb, int I, int J,
                        int K, float omega, float* x, float* rc,
                        void* stream) {
  return launch_down<__nv_bfloat16>(d, l0, l1, l2, b, nb, I, J, K, omega, x,
                                    rc, stream);
}

int flip3d_mg_up_f32(const void* d, const void* l0, const void* l1,
                     const void* l2, const float* b, const float* x,
                     const float* xc, int nb, int I, int J, int K, float omega,
                     float scale, float* out, void* stream) {
  return launch_up<float>(d, l0, l1, l2, b, x, xc, nb, I, J, K, omega, scale,
                          out, stream);
}

int flip3d_mg_up_bf16(const void* d, const void* l0, const void* l1,
                      const void* l2, const float* b, const float* x,
                      const float* xc, int nb, int I, int J, int K,
                      float omega, float scale, float* out, void* stream) {
  return launch_up<__nv_bfloat16>(d, l0, l1, l2, b, x, xc, nb, I, J, K, omega,
                                  scale, out, stream);
}

}  // extern "C"
