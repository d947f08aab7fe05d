// The P2G window faces and the Wyvill weight, shared by the two scatter
// kernels (p2g_scatter.cu, p2g_scatter_stale.cu).
//
// Window face l (< 54): component comp = l / 18, oidx = l % 18, absolute
// offset a of the face from the home cell and the component frame's
// half-cell shift s (0 on the component axis, 0.5 across it), as
// flipviscosity3d_tpu/ops/pallas_particles.py::_p2g_chunk_values.

#pragma once

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
// library is built with -fmad=false).
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

__device__ __forceinline__ float velocity_of(const Face& f, float vx, float vy,
                                             float vz) {
  return f.comp == 0 ? vx : (f.comp == 1 ? vy : vz);
}

}  // namespace flip3d
