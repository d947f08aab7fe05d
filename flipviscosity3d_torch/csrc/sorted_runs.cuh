// The search of a sorted key array shared by the kernels that give a warp
// cells of a tile-key-sorted stream (p2g_scatter.cu, revisit.cu,
// tile_proto.cu): all 32 lanes of the warp probe at once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flip3d {

// First index in key[lo, hi) whose value is not below v (hi if none), the
// same in every lane of the calling warp (all 32 lanes must call). Each
// round the 32 lanes probe 32 points that cut the range into 33 parts and
// one ballot keeps the part that holds the answer: about log33(hi - lo) + 1
// dependent loads, 5 for 35M keys, where a binary search by one lane needs
// 25. T is int, or float for keys held as floats (exact below 2^24).
template <typename T>
__device__ __forceinline__ int warp_lower_bound(const T* __restrict__ key,
                                                int lo, int hi, T v) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int64_t len = hi - lo;
    const int p = lo + (int)(len * (lane + 1) / 33);   // increasing, < hi
    const int m = __popc(__ballot_sync(0xffffffffu, key[p] < v));
    // probes 0 .. m-1 lie below v: the answer is in (p[m-1], p[m]]
    const int below = __shfl_sync(0xffffffffu, p, m == 0 ? 0 : m - 1);
    const int above = __shfl_sync(0xffffffffu, p, m == 32 ? 31 : m);
    if (m < 32) hi = above;
    if (m > 0) lo = below + 1;
  }
  const int q = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, q < hi && key[q] < v));
}

}  // namespace flip3d
