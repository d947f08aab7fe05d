// The P2G window faces, the Wyvill weight and the bf16 split of the JAX
// package's one-hot products, shared by the scatter kernels (p2g_scatter.cu,
// p2g_scatter_stale.cu) and the MAC gather (gather_mac.cu).
//
// Window face l (< 54): component comp = l / 18, oidx = l % 18, absolute
// offset a of the face from the home cell and the component frame's
// half-cell shift s (0 on the component axis, 0.5 across it), as
// flipviscosity3d_tpu/ops/pallas_particles.py::_p2g_chunk_values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flip3d {

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

// The weight expression of _p2g_chunk_values, operation by operation (the
// library is built with -fmad=false), with the parts that do not depend on
// the particle given: a = (g + f.a) * dx and s = f.s * dx per axis.
__device__ __forceinline__ float wyvill_at(float ax, float ay, float az,
                                           float sx, float sy, float sz,
                                           float px, float py, float pz,
                                           float c1, float c2, float c3,
                                           float r2) {
  const float fx = ax - (px - sx);
  const float fy = ay - (py - sy);
  const float fz = az - (pz - sz);
  const float d2 = fx * fx + fy * fy + fz * fz;
  const float w = 1.0f - c1 * d2 * d2 * d2 + c2 * d2 * d2 - c3 * d2;
  return d2 < r2 ? w : 0.f;
}

__device__ __forceinline__ float wyvill(const Face& f, float gi, float gj,
                                        float gk, float px, float py, float pz,
                                        float dx, float c1, float c2, float c3,
                                        float r2) {
  return wyvill_at((gi + f.ax) * dx, (gj + f.ay) * dx, (gk + f.az) * dx,
                   f.sx * dx, f.sy * dx, f.sz * dx, px, py, pz, c1, c2, c3,
                   r2);
}

__device__ __forceinline__ float velocity_of(const Face& f, float vx, float vy,
                                             float vz) {
  return f.comp == 0 ? vx : (f.comp == 1 ? vy : vz);
}

// The JAX package's pallas_split_terms (pallas_particles.py::_split3,
// onehot_dot_split3): at kTerms 1 or 2 the value operand of a one-hot
// product is cut into bf16 terms, bf16(x) and bf16(x - bf16(x)), rounded to
// nearest even; any other kTerms is the exact f32 product.
__device__ __forceinline__ float bf16_term(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x as a split product with a 0/1 one-hot sees it: the sum of its terms
// (exact in f32).
template <int kTerms>
__device__ __forceinline__ float split_round(float x) {
  if (kTerms == 1) return bf16_term(x);
  if (kTerms == 2) {
    const float t1 = bf16_term(x);
    return t1 + bf16_term(x - t1);
  }
  return x;
}

// A sum over particles of split products: each term summed by itself, the
// sums added at the end, as onehot_dot_split3 adds its per-term products.
template <int kTerms>
struct SplitSum {
  float s1 = 0.f, s2 = 0.f;
  __device__ __forceinline__ void add(float x) {
    if (kTerms == 1) {
      s1 = s1 + bf16_term(x);
    } else if (kTerms == 2) {
      const float t1 = bf16_term(x);
      s1 = s1 + t1;
      s2 = s2 + bf16_term(x - t1);
    } else {
      s1 = s1 + x;
    }
  }
  __device__ __forceinline__ float total() const {
    return kTerms == 2 ? s1 + s2 : s1;
  }
};

}  // namespace flip3d
