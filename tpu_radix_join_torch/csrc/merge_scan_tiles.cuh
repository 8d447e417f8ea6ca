// The tile carry of the packed merge scans, shared by K3 (merge_scan.cu) and
// K6 (merge_scan_chunks.cu).
//
// Input of both: a sorted packed union, packed = [pid << (32 - f) |]
// key_remainder << 1 | side, side 0 for the inner (R) and 1 for the outer
// (S) relation (K6 reads it at f = 0).  Every S position weighs the number
// of R tuples in its equal-key run (key = packed >> 1):
//   c_r[i]      = inclusive count of R up to i
//   base_run[i] = cummax over run starts j <= i of (c_r[j] - is_r[j])
//   weight[i]   = is_s[i] * (c_r[i] - base_run[i])
//
// The TPU carried (c_r, base, prev_key) from tile to tile through its
// sequential grid.  On the card:
//   * prev_key needs no carry: it is packed[i - 1] >> 1, read from memory;
//   * c_r is a cross-block prefix sum and base_run a cross-block prefix max.
// So summary_kernel writes, per tile, the R count and the largest run-start
// base inside the tile (relative to the tile, -1 when no run starts there),
// and carry_kernel (one block) scans those into each tile's carried
// (c_r, base).  Each kernel's own weight pass then recomputes a tile with its
// carries.  Each thread owns kItems consecutive positions (odd, so its
// shared-memory reads hit distinct banks).  A run of equal keys longer than
// a tile costs what any other input costs: it is carried through base_run,
// never walked.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace rj_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 15;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // above every packed >> 1

__host__ __device__ inline long long num_tiles(long long m) { return (m + kTile - 1) / kTile; }

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

// The weight pass's entry state for the calling thread: the c_r and base
// carried into its first position, and the key before it.  Every thread of
// the block calls it (it synchronises); `tile` and `prev_tile` were loaded
// by load_tile.
struct ThreadStart {
  uint32_t c_r;
  uint32_t base;
  uint32_t prev;
};

__device__ __forceinline__ ThreadStart thread_start(const uint32_t* tile, uint32_t prev_tile,
                                                    int lo, int hi,
                                                    const uint32_t* __restrict__ carry_r,
                                                    const int* __restrict__ carry_base,
                                                    uint32_t* scratch_u, int* scratch_i) {
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
  return ThreadStart{c_r0, (uint32_t)base0, prev};
}

// Launch summary_kernel and carry_kernel over m packed values; `scratch` is
// 4 * num_tiles(m) words: tile_r, tile_base, carry_r, carry_base.  Returns
// cudaGetLastError().
inline cudaError_t launch_carries(const uint32_t* packed, long long m, uint32_t* scratch,
                                  uint32_t** carry_r, int** carry_base, cudaStream_t st) {
  const long long nt = num_tiles(m);
  uint32_t* tile_r = scratch;
  int* tile_base = reinterpret_cast<int*>(scratch + nt);
  *carry_r = scratch + 2 * nt;
  *carry_base = reinterpret_cast<int*>(scratch + 3 * nt);
  summary_kernel<<<(unsigned)nt, kThreads, 0, st>>>(packed, m, tile_r, tile_base);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<<<1, kCarryThreads, 0, st>>>((int)nt, tile_r, tile_base, *carry_r, *carry_base);
  return cudaGetLastError();
}

}  // namespace rj_scan
