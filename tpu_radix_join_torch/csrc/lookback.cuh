// Look-back words of the single-pass kernels (K3-K6): 64-bit words that a
// block publishes and its successors read while it may still be running.
//
// A word carries its whole message (status and value together), so a reader
// needs no other write of the publishing block: the accesses are relaxed,
// with no fence, and one 8-byte store cannot tear.  The caller zeroes the
// table before the launch, so a zero status means "not yet published".
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rj {

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

}  // namespace rj
