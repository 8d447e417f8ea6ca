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
// Design: the TPU carried (c_r, base, prev_key) from tile to tile through its
// sequential grid.  On the card:
//   * prev_key needs no carry: it is packed[i - 1] >> 1, read from memory;
//   * c_r is a cross-block prefix sum and base_run a cross-block prefix max.
// So summary_kernel writes, per tile, the R count and the largest run-start
// base inside the tile (relative to the tile, -1 when no run starts there);
// carry_kernel (one block) scans those into each tile's carried (c_r, base);
// weight_kernel recomputes the tile with its carries, keeps per-partition
// sums in shared memory (partition ids are sorted, so a thread adds to
// shared memory only where the id changes), and ends with one atomicAdd per
// touched partition and one atomicMax for the weight.  Each thread owns
// kItems consecutive positions (odd, so its shared-memory reads hit distinct
// banks).  A run of equal keys longer than a tile costs what any other input
// costs: it is carried through base_run, never walked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 15;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr int kMaxBins = 128;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // above every packed >> 1

// Load a tile into shared memory; returns its valid length.
__device__ __forceinline__ int load_tile(const uint32_t* __restrict__ packed, long long m,
                                         uint32_t* tile, uint32_t* prev_key) {
  const long long start = (long long)blockIdx.x * kTile;
  const long long rest = m - start;
  const int valid = rest < kTile ? (int)rest : kTile;
  for (int k = threadIdx.x; k < valid; k += kThreads) tile[k] = __ldg(packed + start + k);
  if (threadIdx.x == 0) *prev_key = start > 0 ? (__ldg(packed + start - 1) >> 1) : kNoKey;
  __syncthreads();
  return valid;
}

// The thread's own positions [lo, hi) of the tile: its R count and the R
// count before its last run start (-1 when no run starts there).
__device__ __forceinline__ void thread_summary(const uint32_t* tile, int lo, int hi,
                                               uint32_t prev, uint32_t* count_r,
                                               int* last_start) {
  uint32_t c = 0u;
  int start = -1;
  for (int j = lo; j < hi; ++j) {
    const uint32_t p = tile[j];
    const uint32_t key = p >> 1;
    if (key != prev) start = (int)c;
    c += 1u - (p & 1u);
    prev = key;
  }
  *count_r = c;
  *last_start = start;
}

__global__ void __launch_bounds__(kThreads)
summary_kernel(const uint32_t* __restrict__ packed, long long m,
               uint32_t* __restrict__ tile_r, int* __restrict__ tile_base) {
  __shared__ uint32_t tile[kTile];
  __shared__ uint32_t prev_tile;
  __shared__ uint32_t scratch_u[kWarps];
  __shared__ int scratch_i[kWarps];
  const int valid = load_tile(packed, m, tile, &prev_tile);
  const int lo = threadIdx.x * kItems;
  const int hi = min(lo + kItems, valid);
  uint32_t count_r = 0u;
  int last_start = -1;
  if (lo < hi) {
    const uint32_t prev = lo == 0 ? prev_tile : tile[lo - 1] >> 1;
    thread_summary(tile, lo, hi, prev, &count_r, &last_start);
  }
  uint32_t total_r;
  const uint32_t before = rj::block_exclusive_scan<kThreads>(count_r, 0u, rj::SumOp(),
                                                             scratch_u, &total_r);
  const int cand = last_start >= 0 ? (int)before + last_start : -1;
  int block_max;
  rj::block_exclusive_scan<kThreads>(cand, -1, rj::MaxOp(), scratch_i, &block_max);
  if (threadIdx.x == 0) {
    tile_r[blockIdx.x] = total_r;
    tile_base[blockIdx.x] = block_max;
  }
}

// One block: tile_r -> exclusive prefix (c_r before the tile), tile_base ->
// the base_run carried into the tile (0 before the first run start).
__global__ void __launch_bounds__(kCarryThreads)
carry_kernel(int num_tiles, const uint32_t* __restrict__ tile_r,
             const int* __restrict__ tile_base, uint32_t* __restrict__ carry_r,
             int* __restrict__ carry_base) {
  __shared__ uint32_t scratch_u[kCarryThreads / 32];
  __shared__ int scratch_i[kCarryThreads / 32];
  uint32_t run_r = 0u;
  int run_base = 0;
  for (int c = 0; c < num_tiles; c += kCarryThreads) {
    const int t = c + threadIdx.x;
    const uint32_t r = t < num_tiles ? tile_r[t] : 0u;
    uint32_t chunk_r;
    const uint32_t excl_r =
        rj::block_exclusive_scan<kCarryThreads>(r, 0u, rj::SumOp(), scratch_u, &chunk_r);
    const uint32_t before = run_r + excl_r;
    const int b = t < num_tiles ? tile_base[t] : -1;
    const int cand = b >= 0 ? (int)before + b : -1;
    int chunk_base;
    const int excl_base =
        rj::block_exclusive_scan<kCarryThreads>(cand, -1, rj::MaxOp(), scratch_i, &chunk_base);
    if (t < num_tiles) {
      carry_r[t] = before;
      carry_base[t] = max(run_base, excl_base);
    }
    run_r += chunk_r;
    run_base = max(run_base, chunk_base);
  }
}

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
  const uint32_t prev = lo < hi ? (lo == 0 ? prev_tile : tile[lo - 1] >> 1) : kNoKey;
  uint32_t count_r = 0u;
  int last_start = -1;
  if (lo < hi) thread_summary(tile, lo, hi, prev, &count_r, &last_start);
  const uint32_t c_r0 = carry_r[blockIdx.x] +
      rj::block_exclusive_scan<kThreads>(count_r, 0u, rj::SumOp(), scratch_u,
                                         (uint32_t*)nullptr);
  const int cand = last_start >= 0 ? (int)c_r0 + last_start : -1;
  const int base0 = max(carry_base[blockIdx.x],
                        rj::block_exclusive_scan<kThreads>(cand, -1, rj::MaxOp(), scratch_i,
                                                           (int*)nullptr));
  uint32_t maxw = 0u;
  if (lo < hi) {
    const int pid_shift = 32 - fanout_bits;
    uint32_t c_r = c_r0;
    uint32_t base = (uint32_t)base0;
    uint32_t k_prev = prev;
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
long long rj_merge_scan_num_tiles(long long m) { return (m + kTile - 1) / kTile; }

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
  const long long nt = rj_merge_scan_num_tiles(m);
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  uint32_t* tile_r = static_cast<uint32_t*>(scratch);
  int* tile_base = reinterpret_cast<int*>(tile_r + nt);
  uint32_t* carry_r = tile_r + 2 * nt;
  int* carry_base = reinterpret_cast<int*>(tile_r + 3 * nt);
  summary_kernel<<<(unsigned)nt, kThreads, 0, st>>>(p, m, tile_r, tile_base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_kernel<<<1, kCarryThreads, 0, st>>>((int)nt, tile_r, tile_base, carry_r, carry_base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  weight_kernel<<<(unsigned)nt, kThreads, 0, st>>>(p, m, carry_r, carry_base, fanout_bits,
                                                   static_cast<uint32_t*>(counts),
                                                   static_cast<uint32_t*>(max_weight));
  return (int)cudaGetLastError();
}

}  // extern "C"
