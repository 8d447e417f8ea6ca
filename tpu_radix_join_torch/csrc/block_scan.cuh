// Block-wide exclusive scans built from warp shuffles, shared by the
// radix-sort and merge-scan kernels.  Every thread of the block must call
// them (they synchronise), with the block size given as a template argument.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rj {

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a > b ? a : b; }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_inclusive_scan(T v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = op(v, y);
  }
  return v;
}

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Exclusive scan of one value per thread in thread order.  `scratch` holds
// at least kThreads / 32 values; `total` (may be null) receives the scan of
// the whole block.  kThreads is a multiple of 32 and at most 1024.
template <int kThreads, typename T, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T v, T identity, Op op, T* scratch,
                                                  T* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = warp_inclusive_scan(v, op);
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? scratch[lane] : identity;
    w = warp_inclusive_scan(w, op);
    if (lane < kWarps) scratch[lane] = w;
  }
  __syncthreads();
  T excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = identity;
  if (warp > 0) excl = op(scratch[warp - 1], excl);
  if (total != nullptr) *total = scratch[kWarps - 1];
  __syncthreads();  // scratch may be reused by the caller's next scan
  return excl;
}

}  // namespace rj
