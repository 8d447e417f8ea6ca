// K6: per-window merge-weight sums, the count of the out-of-core grid.
//
// Replaces tpu_radix_join/ops/pallas/merge_scan.py::merge_scan_chunks
// (_kernel over _tile_scan).  Input: a sorted packed union, packed =
// key << 1 | side (side 0 for the inner relation R, 1 for the outer S), which
// is K3's layout at fanout 0.  Every S position weighs the number of R
// tuples in its equal-key run (merge_scan_lookback.cuh).  Output: for a
// window width w, the uint32 sum of the weights of each window [k w,
// (k + 1) w) of positions (wrapping mod 2**32 like the TPU's int32 sums),
// ceil(m / w) words, and the largest single weight.  At w = 32768, the TPU's
// tile, these are merge_scan_chunks' per-tile counts; at w = ceil(m / c) they
// are the c partial counts of merge_count_chunks.  Any length works: the TPU
// kernel's tile multiple was Mosaic's requirement.
//
// Bound on the H100: bytes.  The function must read the packed lane once
// and write the window sums once, 4 m + 4 ceil(m / w) bytes at 3.35 TB/s.
//
// Design: one launch that reads the lane once.  A block claims the next tile
// of kTile positions from a counter and loads it into shared memory with
// 16-byte loads.  Each thread owns kItems consecutive positions (odd, so its
// shared-memory reads hit distinct banks) and summarises them; two block
// scans give the tile's summary (R, B) and every thread's place in it.  Warp
// 0 carries the tiles before by decoupled look-back (merge_scan_lookback.cuh)
// while the other warps wait at the barrier.  Every thread then weighs its
// positions from the copy in shared memory and bins the weights by window.
// When w >= kTile a tile touches at most two windows: the block reduces both
// sums and adds each with one atomicAdd.  Narrower windows are flushed per
// thread (per warp when a warp's positions share one window) wherever its
// positions cross a window boundary.  The block ends with one atomicMax for
// the weight.  The look-back table, the tile counter, the max word and the
// window sums are one scratch block, zeroed by one memset.  A thread holds
// 39 items (a tile of 9,984 positions), which spreads a tile's fixed costs
// (the counter, the block scans, the look-back) over more positions.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it): 47 registers, 40,112
// bytes of shared memory, no spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "merge_scan_lookback.cuh"

namespace {

using rj_carry::Carry;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 39;
constexpr int kTile = kThreads * kItems;  // SCAN_TILE in ops/kernels/merge_scan_chunks.py
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // above every packed >> 1
static_assert(kTile % 4 == 0, "a tile is whole 16-byte words");

// One position: advances (c_r, base, prev) and returns its weight.
__device__ __forceinline__ uint32_t weigh(uint32_t p, uint32_t& c_r, uint32_t& base,
                                          uint32_t& prev) {
  const uint32_t key = p >> 1;
  const uint32_t is_s = p & 1u;
  c_r += 1u - is_s;
  if (key != prev) base = c_r - (1u - is_s);
  prev = key;
  return is_s * (c_r - base);
}

__global__ void __launch_bounds__(kThreads)
chunks_kernel(const uint32_t* __restrict__ packed, long long m, uint32_t width,
              uint32_t* __restrict__ sums, uint32_t* __restrict__ max_weight,
              unsigned long long* __restrict__ lookback, uint32_t* __restrict__ tile_counter) {
  __shared__ __align__(16) uint32_t tile[kTile];
  __shared__ uint32_t scratch_u[kWarps];
  __shared__ int scratch_i[kWarps];
  __shared__ uint32_t red[3][kWarps];
  __shared__ uint32_t tile_shared;
  __shared__ uint32_t prev_shared;
  __shared__ Carry carry_shared;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) tile_shared = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const uint32_t t = tile_shared;
  const long long start = (long long)t * kTile;
  const int valid = (int)min((long long)kTile, m - start);
  const uint32_t* src = packed + start;
  if (valid == kTile && ((uintptr_t)src & 15u) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(src);
    uint4* dst = reinterpret_cast<uint4*>(tile);
    for (int k = tid; k < kTile / 4; k += kThreads) dst[k] = __ldg(v + k);
  } else {
    for (int k = tid; k < valid; k += kThreads) tile[k] = __ldg(src + k);
  }
  if (tid == 0) prev_shared = start > 0 ? (__ldg(packed + start - 1) >> 1) : kNoKey;
  __syncthreads();

  // the thread's positions [lo, hi): its R count and the R count before its
  // last run start (-1 when no run starts there)
  const int lo = tid * kItems;
  const int hi = min(lo + kItems, valid);
  const uint32_t prev = lo < hi ? (lo == 0 ? prev_shared : tile[lo - 1] >> 1) : kNoKey;
  uint32_t count_r = 0u;
  int last_start = -1;
  {
    uint32_t k_prev = prev;
    for (int j = lo; j < hi; ++j) {
      const uint32_t p = tile[j];
      if ((p >> 1) != k_prev) last_start = (int)count_r;
      count_r += 1u - (p & 1u);
      k_prev = p >> 1;
    }
  }
  uint32_t tile_r;
  const uint32_t excl_r =
      rj::block_exclusive_scan<kThreads>(count_r, 0u, rj::SumOp(), scratch_u, &tile_r);
  const int cand = last_start >= 0 ? (int)excl_r + last_start : -1;
  int tile_base;
  const int excl_base =
      rj::block_exclusive_scan<kThreads>(cand, -1, rj::MaxOp(), scratch_i, &tile_base);
  if (warp == 0) {
    const Carry before = rj_carry::lookback(lookback, t, Carry{tile_r, tile_base});
    if (lane == 0) carry_shared = before;
  }
  __syncthreads();
  const Carry before = carry_shared;

  // the state carried into the thread's first position; position 0 starts
  // a run, so base_run is defined wherever it is read
  uint32_t c_r = before.r + excl_r;
  const int b0 = max(before.base, excl_base >= 0 ? (int)before.r + excl_base : -1);
  uint32_t base = b0 >= 0 ? (uint32_t)b0 : 0u;
  uint32_t k_prev = prev;
  uint32_t maxw = 0u;
  // positions count below 2**31, so a position and a window end fit uint32
  const uint32_t g0 = (uint32_t)start;
  uint32_t acc0 = 0u;
  uint32_t acc1 = 0u;
  if (width >= (uint32_t)kTile) {
    // block-uniform: the tile's windows are w0 and w0 + 1
    const uint32_t split = (g0 / width + 1u) * width;
    for (int j = lo; j < hi; ++j) {
      const uint32_t w = weigh(tile[j], c_r, base, k_prev);
      if (g0 + (uint32_t)j < split) {
        acc0 += w;
      } else {
        acc1 += w;
      }
      maxw = w > maxw ? w : maxw;
    }
  } else {
    const int warp_lo = warp * 32 * kItems;
    const int warp_hi = min(warp_lo + 32 * kItems, valid);
    // warp-uniform: the warp's positions [warp_lo, warp_hi) share one window
    const bool one_window =
        warp_lo < warp_hi && (g0 + warp_lo) / width == (g0 + warp_hi - 1) / width;
    uint32_t win = 0u;
    if (lo < hi) {
      win = (g0 + lo) / width;
      uint32_t next = (win + 1u) * width;
      for (int j = lo; j < hi; ++j) {
        const uint32_t g = g0 + j;
        if (!one_window && g >= next) {
          if (acc0 != 0u) atomicAdd(sums + win, acc0);
          win = g / width;
          next = (win + 1u) * width;
          acc0 = 0u;
        }
        const uint32_t w = weigh(tile[j], c_r, base, k_prev);
        acc0 += w;
        maxw = w > maxw ? w : maxw;
      }
    }
    if (one_window) {
      acc0 = rj::warp_reduce(acc0, rj::SumOp());
      if (lane == 0 && acc0 != 0u) atomicAdd(sums + (g0 + warp_lo) / width, acc0);
    } else if (acc0 != 0u) {
      atomicAdd(sums + win, acc0);
    }
    acc0 = 0u;  // added: the block adds nothing more
  }
  acc0 = rj::warp_reduce(acc0, rj::SumOp());
  acc1 = rj::warp_reduce(acc1, rj::SumOp());
  maxw = rj::warp_reduce(maxw, rj::MaxOp());
  if (lane == 0) {
    red[0][warp] = acc0;
    red[1][warp] = acc1;
    red[2][warp] = maxw;
  }
  __syncthreads();
  if (tid == 0) {
    uint32_t s0 = 0u, s1 = 0u, mx = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s0 += red[0][w];
      s1 += red[1][w];
      mx = red[2][w] > mx ? red[2][w] : mx;
    }
    const uint32_t w0 = g0 / width;
    if (s0 != 0u) atomicAdd(sums + w0, s0);
    if (s1 != 0u) atomicAdd(sums + w0 + 1u, s1);
    if (mx != 0u) atomicMax(max_weight, mx);
  }
}

}  // namespace

extern "C" {

// packed: sorted uint32 [m]; scratch: one block of scratch_bytes =
// 8 * num_tiles + 8 + 4 * ceil(m / width) bytes, laid out as the look-back
// table (num_tiles words of 8 bytes), the tile counter, the max weight and
// the ceil(m / width) window sums (uint32 each).  Zeroes the block with one
// memset, launches one kernel on `stream` and returns cudaGetLastError().
int rj_merge_scan_chunks(const void* packed, long long m, long long width, void* scratch,
                         long long scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 0 || m > 0x7FFFFFFFll || width < 1 || width > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (m + kTile - 1) / kTile;  // num_tiles
  const long long windows = (m + width - 1) / width;
  if (scratch_bytes != 8 * tiles + 8 + 4 * windows) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)scratch_bytes, st);
  if (err != cudaSuccess || m == 0) return (int)(err != cudaSuccess ? err : cudaGetLastError());
  unsigned long long* lookback = static_cast<unsigned long long*>(scratch);
  uint32_t* tail = reinterpret_cast<uint32_t*>(lookback + tiles);
  chunks_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(packed), m, (uint32_t)width, tail + 2, tail + 1, lookback,
      tail);
  return (int)cudaGetLastError();
}

}  // extern "C"
