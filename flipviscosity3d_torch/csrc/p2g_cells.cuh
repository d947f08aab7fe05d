// The walk of one warp over the particles of 32 consecutive cells, in
// stream order, shared by the scatters that give a warp such a run: K1
// (p2g_scatter.cu, a tile-key-sorted stream), K5's sums half
// (p2g_scatter_stale.cu, an unsorted stream read through its per-tile
// order) and K11 (tile_proto.cu, the prototype's payload).
//
// The warp streams its run [start, end) 32 particles at a time: lane l
// loads particle b + l (the next batch in flight while the current one is
// summed), writes its slot-table entry if its rank is below cap, and stages
// it in shared memory; then the warp walks the batch in stream order, each
// particle read by two broadcast 16-byte loads. Lane l owns window faces l
// and l + 32 of the current cell and sums them in registers; where the
// particle's cell changes, the warp closes the finished cell (its sums, its
// empty slots [count, cap)) and writes every empty cell between as zeros.
// Each cell's sums are added in stream order with the weight expression of
// _p2g_chunk_values (the library is built with -fmad=false), so the result
// does not depend on which kernel walks the run, nor vary from run to run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "p2g_wyvill.cuh"

namespace flip3d {

// A particle of the run as the walk stages it: its position and velocity,
// its cell among the warp's 32 (0..31) and its rank in that cell.
struct Particle {
  float x, y, z, vx, vy, vz;
  int i, r;
};

// One lane's window faces l and l + 32 of the cell being summed: the parts
// of the weight that do not depend on the particle, and the sums.
template <int kTerms>
struct LaneFaces {
  float a0x, a0y, a0z, s0x, s0y, s0z, a1x, a1y, a1z, s1x, s1y, s1z;
  SplitSum<kTerms> w0, wv0, w1, wv1;
};

// Sums the run [start, end) of the warp's cells, whose cell i (0..31) is
// grid cell (gi, gj0 + i / 8, gk0 + i % 8). Every lane of the warp calls it;
// `batch` is the warp's 32 x 2 float4 of shared memory.
//   src.load(p)      issues the loads of particle p into the lane's
//                    registers (every lane; p may be past the run)
//   src.next(p)      the particle loaded for p (every lane; valid if
//                    p < end)
//   out.slot(pt)     writes pt's slot-table entry (a lane whose particle's
//                    rank is below cap)
//   out.close(i, count, faces)  writes cell i's sums and zeroes its slots
//                    [count, cap) (every lane)
//   out.zero(i)      writes cell i as empty (every lane)
template <int kTerms, class Src, class Out>
__device__ __forceinline__ void sum_cells(Src& src, Out& out,
                                          float4 (*batch)[2], int start,
                                          int end, int gi, int gj0, int gk0,
                                          int cap, float dx, float c1,
                                          float c2, float c3, float r2) {
  const int lane = threadIdx.x & 31;
  const bool has2 = lane + 32 < 54;
  const Face f0 = face_of(lane);
  const Face f1 = face_of(has2 ? lane + 32 : lane);

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

  int cur = 0, count = 0;  // the cell being summed, its particles so far
  begin_cell(0);
  src.load(start + lane);
  for (int b = start; b < end; b += 32) {
    const Particle pt = src.next(b + lane);
    if (b + lane < end) {
      if (pt.r < cap) out.slot(pt);
      batch[lane][0] = make_float4(pt.x, pt.y, pt.z, pt.vx);
      batch[lane][1] = make_float4(pt.vy, pt.vz, __int_as_float(pt.i), 0.f);
    }
    __syncwarp();
    src.load(b + 32 + lane);  // in flight while this batch is summed
    const int nb = min(32, end - b);
    for (int j = 0; j < nb; ++j) {
      const float4 pa = batch[j][0], pb = batch[j][1];
      const int i = __float_as_int(pb.z);
      if (i != cur) {  // the same in every lane
        out.close(cur, count, lf);
        for (int e = cur + 1; e < i; ++e) out.zero(e);
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
  out.close(cur, count, lf);
  for (int e = cur + 1; e < 32; ++e) out.zero(e);
}

// The output of K1 and K5: a row of kStride floats per cell (standard
// i-major layout; lanes 108..kStride zero) and cap float4 slots per cell.
// The warp's cell i is cell0 + (i / 8) * K + i % 8.
template <int kStride, int kTerms>
struct CellRows {
  float* __restrict__ sums;
  float4* __restrict__ table4;
  int64_t cell0;
  int K, cap;

  __device__ __forceinline__ int64_t cell(int i) const {
    return cell0 + (int64_t)(i >> 3) * K + (i & 7);
  }
  __device__ __forceinline__ void slot(const Particle& pt) const {
    table4[cell(pt.i) * cap + pt.r] =
        make_float4(split_round<kTerms>(pt.x), split_round<kTerms>(pt.y),
                    split_round<kTerms>(pt.z), 1.0f);
  }
  __device__ __forceinline__ void close(int i, int count,
                                        const LaneFaces<kTerms>& lf) const {
    const int lane = threadIdx.x & 31;
    const int64_t c = cell(i);
    float* out = sums + c * kStride;
    out[lane] = lf.w0.total();
    out[54 + lane] = lf.wv0.total();
    if (lane + 32 < 54) {
      out[lane + 32] = lf.w1.total();
      out[54 + lane + 32] = lf.wv1.total();
    }
    if (lane < kStride - 108) out[108 + lane] = 0.f;
    if (lane >= count && lane < cap)
      table4[c * cap + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void zero(int i) const {
    const int lane = threadIdx.x & 31;
    const int64_t c = cell(i);
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane < kStride / 4)
      reinterpret_cast<float4*>(sums + c * kStride)[lane] = zero4;
    if (lane < cap) table4[c * cap + lane] = zero4;
  }
};

}  // namespace flip3d
