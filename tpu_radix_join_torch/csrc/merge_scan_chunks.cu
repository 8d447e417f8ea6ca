// K6: per-window merge-weight sums, the count of the out-of-core grid.
//
// Replaces tpu_radix_join/ops/pallas/merge_scan.py::merge_scan_chunks
// (_kernel over _tile_scan).  Input: a sorted packed union, packed =
// key << 1 | side (side 0 for the inner relation R, 1 for the outer S), which
// is K3's layout at fanout 0.  Every S position weighs the number of R
// tuples in its equal-key run (merge_scan_tiles.cuh).  Output: for a window
// width w, the uint32 sum of the weights of each window [k w, (k + 1) w) of
// positions (wrapping mod 2**32 like the TPU's int32 sums), ceil(m / w)
// words, and the largest single weight.  At w = 32768, the TPU's tile, these
// are merge_scan_chunks' per-tile counts; at w = ceil(m / c) they are the
// c partial counts of merge_count_chunks.  Any length works: the TPU
// kernel's tile multiple was Mosaic's requirement.
//
// Bound on the H100: bytes.  The function must read the packed lane once
// and write the window sums once, 4 m + 4 ceil(m / w) bytes at 3.35 TB/s.
// This design reads the lane twice (summary and weight passes) plus two
// words per tile.
//
// Design: the tile carry of K3 (merge_scan_tiles.cuh) gives each tile its
// carried (c_r, base_run); window_kernel recomputes the tile and bins its
// weights by window index i / w instead of by partition id.  A warp whose
// positions all lie in one window sums them with a warp reduction and one
// atomicAdd; otherwise each thread flushes its partial sum with one atomicAdd
// wherever its positions cross a window boundary (w may be smaller than a
// thread's items, or not divide the tile).  The block ends with one atomicMax
// for the weight.  The window sums are zeroed on the launch stream first.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_scan_tiles.cuh"

namespace {

using namespace rj_scan;

__global__ void __launch_bounds__(kThreads)
window_kernel(const uint32_t* __restrict__ packed, long long m,
              const uint32_t* __restrict__ carry_r, const int* __restrict__ carry_base,
              uint32_t width, uint32_t* __restrict__ sums, uint32_t* __restrict__ max_weight) {
  __shared__ uint32_t tile[kTile];
  __shared__ uint32_t prev_tile;
  __shared__ uint32_t scratch_u[kWarps];
  __shared__ int scratch_i[kWarps];
  __shared__ uint32_t block_maxw;
  if (threadIdx.x == 0) block_maxw = 0u;
  const int valid = load_tile(packed, m, tile, &prev_tile);  // synchronises
  const int lo = threadIdx.x * kItems;
  const int hi = min(lo + kItems, valid);
  const ThreadStart st = thread_start(tile, prev_tile, lo, hi, carry_r, carry_base,
                                      scratch_u, scratch_i);
  // positions count below 2**31, so a position and a window end fit uint32
  const uint32_t start = (uint32_t)blockIdx.x * (uint32_t)kTile;
  const int warp_lo = (threadIdx.x & ~31) * kItems;
  const int warp_hi = min(warp_lo + 32 * kItems, valid);
  // warp-uniform: the warp's positions [warp_lo, warp_hi) share one window
  const bool one_window =
      warp_lo < warp_hi && (start + warp_lo) / width == (start + warp_hi - 1) / width;
  uint32_t maxw = 0u;
  uint32_t acc = 0u;
  uint32_t win = 0u;
  if (lo < hi) {
    win = (start + lo) / width;
    uint32_t next = (win + 1u) * width;
    uint32_t c_r = st.c_r;
    uint32_t base = st.base;
    uint32_t k_prev = st.prev;
    for (int j = lo; j < hi; ++j) {
      const uint32_t g = start + j;
      if (!one_window && g >= next) {
        if (acc != 0u) atomicAdd(sums + win, acc);
        win = g / width;
        next = (win + 1u) * width;
        acc = 0u;
      }
      const uint32_t p = tile[j];
      const uint32_t key = p >> 1;
      const uint32_t is_s = p & 1u;
      c_r += 1u - is_s;
      if (key != k_prev) base = c_r - (1u - is_s);
      k_prev = key;
      const uint32_t w = is_s * (c_r - base);
      acc += w;
      maxw = w > maxw ? w : maxw;
    }
  }
  if (one_window) {
    acc = rj::warp_reduce(acc, rj::SumOp());
    if ((threadIdx.x & 31) == 0 && acc != 0u) atomicAdd(sums + (start + warp_lo) / width, acc);
  } else if (acc != 0u) {
    atomicAdd(sums + win, acc);
  }
  maxw = rj::warp_reduce(maxw, rj::MaxOp());
  if ((threadIdx.x & 31) == 0 && maxw != 0u) atomicMax(&block_maxw, maxw);
  __syncthreads();
  if (threadIdx.x == 0 && block_maxw != 0u) atomicMax(max_weight, block_maxw);
}

}  // namespace

extern "C" {

// Scratch the caller allocates for m packed values: num_tiles words each of
// tile_r, tile_base, carry_r and carry_base.
long long rj_merge_scan_chunks_num_tiles(long long m) { return num_tiles(m); }

// packed: sorted uint32 [m]; sums: uint32 [ceil(m / width)]; max_weight:
// uint32 [1]; scratch: 4 * num_tiles uint32 words.  Zeroes the outputs,
// launches on `stream` and returns cudaGetLastError().
int rj_merge_scan_chunks(const void* packed, long long m, long long width, void* sums,
                         void* max_weight, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 0 || m > 0x7FFFFFFFll || width < 1 || width > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const long long num_windows = (m + width - 1) / width;
  cudaError_t err = cudaMemsetAsync(max_weight, 0, sizeof(uint32_t), st);
  if (err == cudaSuccess && num_windows > 0)
    err = cudaMemsetAsync(sums, 0, sizeof(uint32_t) * num_windows, st);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return (int)cudaGetLastError();
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  uint32_t* carry_r;
  int* carry_base;
  err = launch_carries(p, m, static_cast<uint32_t*>(scratch), &carry_r, &carry_base, st);
  if (err != cudaSuccess) return (int)err;
  window_kernel<<<(unsigned)num_tiles(m), kThreads, 0, st>>>(
      p, m, carry_r, carry_base, (uint32_t)width, static_cast<uint32_t*>(sums),
      static_cast<uint32_t*>(max_weight));
  return (int)cudaGetLastError();
}

}  // extern "C"
