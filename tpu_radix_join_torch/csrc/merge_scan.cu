// K3: the fused merge-weight scan of the sort probe.
//
// Replaces tpu_radix_join/ops/pallas/merge_scan.py::merge_scan_partitions
// (_kernel_partitions over _tile_scan).  Input: the sorted partition-major
// packed union, packed = pid << (32 - f) | key_remainder << 1 | side, side 0
// for the inner (R) and 1 for the outer (S) relation.  Every S position
// weighs the number of R tuples in its equal-key run (key = packed >> 1):
//   c_r[i]      = inclusive count of R up to i
//   base_run[i] = cummax over run starts j <= i of (c_r[j] - is_r[j])
//   weight[i]   = is_s[i] * (c_r[i] - base_run[i])
// Output: per-partition uint32 sums of the weights (wrapping mod 2**32 like
// the TPU's int32 sums) and the largest single weight.  Any length works:
// the TPU kernel's tile multiple was Mosaic's requirement.
//
// Bound on the H100: bytes.  The function must read the packed lane once,
// 4 m bytes at 3.35 TB/s; the outputs are P + 1 words.
//
// Design: one memset and one launch that reads the lane once
// (merge_scan_partitions.cuh, shared with K5): tiles of 9,984 positions from
// a counter, each loaded with 16-byte loads into one word a position
// (partition id, run start, side), the carry composed in tile order by
// decoupled look-back (merge_scan_lookback.cuh, K6's), the weights binned by
// partition in shared memory.  A run starts where packed >> 1 differs from
// the position before; the key before a tile is packed[start - 1] >> 1, read
// from memory.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it): 32 registers, 40,560
// bytes of shared memory, no spills: five blocks an SM, held by the shared
// memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_scan_partitions.cuh"

namespace {

// The packed lane as merge_scan_partitions.cuh's load_words reads it.
struct PackedLane {
  using Pos = uint32_t;
  const uint32_t* __restrict__ packed;
  int fanout_bits;

  __device__ __forceinline__ Pos load(long long i) const { return __ldg(packed + i); }
  __device__ __forceinline__ void load4(long long i, Pos* p) const {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(packed + i));
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
  __device__ __forceinline__ bool aligned(long long i) const {
    return ((uintptr_t)(packed + i) & 15u) == 0;
  }
  __device__ __forceinline__ static Pos shfl_up(Pos p) {
    return __shfl_up_sync(0xffffffffu, p, 1);
  }
  // ~p >> 1 differs from p >> 1 in every bit
  __device__ __forceinline__ static Pos unlike(Pos p) { return ~p; }
  __device__ __forceinline__ uint32_t word(Pos p, Pos prev) const {
    return rj_bins::word(fanout_bits ? p >> (32 - fanout_bits) : 0u, (p >> 1) != (prev >> 1),
                         p & 1u);
  }
};

}  // namespace

extern "C" {

// packed: sorted uint32 [m], m < 2**31; fanout_bits <= 30; scratch: one block
// of scratch_bytes = 8 * num_tiles + 8 + 4 * 2**fanout_bits bytes, laid out as
// the look-back table (num_tiles words of 8 bytes), the tile counter, the
// max weight and the 1 << fanout_bits partition counts (uint32 each).
// Refuses any other size.  Zeroes the block with one memset, launches one
// kernel on `stream` and returns a cudaError_t.
int rj_merge_scan(const void* packed, long long m, int fanout_bits, void* scratch,
                  long long scratch_bytes, void* stream) {
  return rj_bins::launch(PackedLane{static_cast<const uint32_t*>(packed), fanout_bits}, m,
                         fanout_bits, scratch, scratch_bytes, stream);
}

}  // extern "C"
