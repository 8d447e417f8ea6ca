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
// 4 m bytes at 3.35 TB/s; the outputs are P + 1 words.  This design reads it
// twice (2 x 4 m bytes) plus two words per block.
//
// Design: the tile carry (merge_scan_tiles.cuh, shared with K6) gives each
// tile its carried (c_r, base_run); weight_kernel recomputes the tile with
// its carries, keeps per-partition sums in shared memory (partition ids are
// sorted, so a thread adds to shared memory only where the id changes), and
// ends with one atomicAdd per touched partition and one atomicMax for the
// weight.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_scan_tiles.cuh"

namespace {

using namespace rj_scan;

constexpr int kMaxBins = 128;

__global__ void __launch_bounds__(kThreads)
weight_kernel(const uint32_t* __restrict__ packed, long long m,
              const uint32_t* __restrict__ carry_r, const int* __restrict__ carry_base,
              int fanout_bits, uint32_t* __restrict__ counts, uint32_t* __restrict__ max_weight) {
  __shared__ uint32_t tile[kTile];
  __shared__ uint32_t prev_tile;
  __shared__ uint32_t scratch_u[kWarps];
  __shared__ int scratch_i[kWarps];
  __shared__ uint32_t bins[kMaxBins];
  __shared__ uint32_t block_maxw;
  for (int b = threadIdx.x; b < kMaxBins; b += kThreads) bins[b] = 0u;
  if (threadIdx.x == 0) block_maxw = 0u;
  const int valid = load_tile(packed, m, tile, &prev_tile);  // synchronises
  const int lo = threadIdx.x * kItems;
  const int hi = min(lo + kItems, valid);
  const ThreadStart st = thread_start(tile, prev_tile, lo, hi, carry_r, carry_base,
                                      scratch_u, scratch_i);
  uint32_t maxw = 0u;
  if (lo < hi) {
    const int pid_shift = 32 - fanout_bits;
    uint32_t c_r = st.c_r;
    uint32_t base = st.base;
    uint32_t k_prev = st.prev;
    uint32_t cur_pid = fanout_bits ? tile[lo] >> pid_shift : 0u;
    uint32_t acc = 0u;
    for (int j = lo; j < hi; ++j) {
      const uint32_t p = tile[j];
      const uint32_t key = p >> 1;
      const uint32_t is_s = p & 1u;
      c_r += 1u - is_s;
      if (key != k_prev) base = c_r - (1u - is_s);
      k_prev = key;
      const uint32_t w = is_s * (c_r - base);
      const uint32_t pid = fanout_bits ? p >> pid_shift : 0u;
      if (pid != cur_pid) {
        if (acc != 0u) atomicAdd(bins + cur_pid, acc);
        cur_pid = pid;
        acc = 0u;
      }
      acc += w;
      maxw = w > maxw ? w : maxw;
    }
    if (acc != 0u) atomicAdd(bins + cur_pid, acc);
  }
  maxw = rj::warp_reduce(maxw, rj::MaxOp());
  if ((threadIdx.x & 31) == 0 && maxw != 0u) atomicMax(&block_maxw, maxw);
  __syncthreads();
  const int num_bins = 1 << fanout_bits;
  for (int b = threadIdx.x; b < num_bins; b += kThreads) {
    if (bins[b] != 0u) atomicAdd(counts + b, bins[b]);
  }
  if (threadIdx.x == 0 && block_maxw != 0u) atomicMax(max_weight, block_maxw);
}

}  // namespace

extern "C" {

// Scratch the caller allocates for m packed values: num_tiles words each of
// tile_r, tile_base, carry_r and carry_base.
long long rj_merge_scan_num_tiles(long long m) { return num_tiles(m); }

// packed: sorted uint32 [m]; counts: uint32 [1 << fanout_bits]; max_weight:
// uint32 [1]; scratch: 4 * num_tiles uint32 words.  Zeroes the outputs,
// launches on `stream` and returns cudaGetLastError().
int rj_merge_scan(const void* packed, long long m, int fanout_bits, void* counts,
                  void* max_weight, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fanout_bits < 0 || fanout_bits > 7 || m < 0 || m > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(uint32_t) << fanout_bits, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(max_weight, 0, sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return (int)cudaGetLastError();
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  uint32_t* carry_r;
  int* carry_base;
  err = launch_carries(p, m, static_cast<uint32_t*>(scratch), &carry_r, &carry_base, st);
  if (err != cudaSuccess) return (int)err;
  weight_kernel<<<(unsigned)num_tiles(m), kThreads, 0, st>>>(
      p, m, carry_r, carry_base, fanout_bits, static_cast<uint32_t*>(counts),
      static_cast<uint32_t*>(max_weight));
  return (int)cudaGetLastError();
}

}  // extern "C"
