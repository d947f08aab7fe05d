// The run of one key in a sorted key array, shared by the kernels that give
// a warp one cell of a tile-key-sorted stream (p2g_scatter.cu, revisit.cu):
// lane 0 finds the run by two binary searches and hands it to the warp.

#pragma once

#include <cuda_runtime.h>

namespace flip3d {

// First index in key[0, n) whose value is not below v.
__device__ __forceinline__ int lower_bound(const int* __restrict__ key, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// [start, end) of the elements equal to v, the same in every lane of the
// calling warp (all 32 lanes must call).
__device__ __forceinline__ void warp_run_of(const int* __restrict__ key, int n,
                                            int v, int& start, int& end) {
  start = end = 0;
  if ((threadIdx.x & 31) == 0) {
    start = lower_bound(key, n, v);
    end = lower_bound(key, n, v + 1);
  }
  start = __shfl_sync(0xffffffffu, start, 0);
  end = __shfl_sync(0xffffffffu, end, 0);
}

}  // namespace flip3d
