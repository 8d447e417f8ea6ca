// K2: one stable 8-bit LSD radix pass over a uint32 key lane.
//
// Replaces tpu_radix_join/ops/pallas/radix_sort.py::radix_pass_slots_pallas
// (_digit_kernel), driven there by radix_sort_pallas.  Contract: slots[i] is
// key i's destination when grouping by digit (key >> shift) & 0xFF -- a dense
// permutation of [0, n), digit order across groups, input order within one.
// The same pass can move up to four uint32 lanes to those destinations itself.
//
// Bound on the H100: bytes.  A sort of n keys must read and write each lane
// once (8 n bytes per lane at 3.35 TB/s).  One pass here reads the key lane
// twice and every moved lane once, and writes every moved lane once, with
// scattered 4-byte stores; four passes sort a full uint32 key.
//
// Design: the TPU pass was stable across tiles for free, because its grid ran
// in order and carried the digit cursors in SMEM.  CUDA blocks run in no
// order, so each pass is reduce-then-scan over tiles of kTile keys:
//   1. digit_hist_kernel: every block counts its tile's digits into a
//      digit-major table counts[digit * num_blocks + block];
//   2. digit_scan_kernel: one block per digit turns its row into an exclusive
//      scan and stores the row total;
//   3. scatter_kernel: every block scans the 256 row totals into digit bases,
//      then walks its tile in rounds of 256 keys.  Within a round a warp ranks
//      equal digits with __match_any_sync, warps are ordered through per-warp
//      digit counts in shared memory, and the block's per-digit cursor
//      advances after each round.  Positions are therefore assigned in input
//      order within a digit, and each pass is stable.
// Rows past n take no part, like the TPU kernel's pad rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;  // one thread per digit in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;
constexpr int kScanThreads = 1024;
constexpr int kMaxLanes = 4;

struct Lanes {
  const uint32_t* in[kMaxLanes];
  uint32_t* out[kMaxLanes];
  int count;
};

__global__ void __launch_bounds__(kThreads)
digit_hist_kernel(const uint32_t* __restrict__ keys, long long n, int shift,
                  uint32_t* __restrict__ counts, int num_blocks) {
  __shared__ uint32_t hist[kRadix];
  hist[threadIdx.x] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kThreads + threadIdx.x;
    const bool valid = i < n;
    const int d = valid ? (int)((__ldg(keys + i) >> shift) & 0xFFu) : kRadix;
    // warp-aggregated add: one shared atomic per distinct digit per warp
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(hist + d, (uint32_t)__popc(peers));
  }
  __syncthreads();
  counts[(long long)threadIdx.x * num_blocks + blockIdx.x] = hist[threadIdx.x];
}

// One block per digit: row `blockIdx.x` of counts becomes its exclusive scan;
// its total goes to totals[digit].
__global__ void __launch_bounds__(kScanThreads)
digit_scan_kernel(uint32_t* __restrict__ counts, int num_blocks,
                  uint32_t* __restrict__ totals) {
  __shared__ uint32_t scratch[kScanThreads / 32];
  uint32_t* row = counts + (long long)blockIdx.x * num_blocks;
  uint32_t carry = 0u;
  for (int c = 0; c < num_blocks; c += kScanThreads) {
    const int j = c + threadIdx.x;
    const uint32_t v = j < num_blocks ? row[j] : 0u;
    uint32_t chunk_total;
    const uint32_t excl =
        rj::block_exclusive_scan<kScanThreads>(v, 0u, rj::SumOp(), scratch, &chunk_total);
    if (j < num_blocks) row[j] = carry + excl;
    carry += chunk_total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint32_t* __restrict__ keys, long long n, int shift,
               const uint32_t* __restrict__ counts, int num_blocks,
               const uint32_t* __restrict__ totals, uint32_t* __restrict__ slots,
               Lanes lanes) {
  __shared__ uint32_t scratch[kWarps];
  __shared__ uint32_t cursor[kRadix];
  __shared__ uint32_t warp_cnt[kWarps][kRadix];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;

  const uint32_t digit_base =
      rj::block_exclusive_scan<kThreads>(totals[tid], 0u, rj::SumOp(), scratch,
                                         (uint32_t*)nullptr);
  cursor[tid] = digit_base + counts[(long long)tid * num_blocks + blockIdx.x];

  const long long base = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const long long row = base + (long long)r * kThreads;
    if (row >= n) break;  // uniform across the block
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_cnt[w][tid] = 0u;
    __syncthreads();
    const long long i = row + tid;
    const bool valid = i < n;
    const uint32_t key = valid ? __ldg(keys + i) : 0u;
    const int d = valid ? (int)((key >> shift) & 0xFFu) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const uint32_t rank = (uint32_t)__popc(peers & lanemask_lt);
    if (valid && rank == 0u) warp_cnt[warp][d] = (uint32_t)__popc(peers);
    __syncthreads();
    // thread `tid` owns digit `tid`: exclusive prefix over warps, in warp order
    uint32_t round_total = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t t = warp_cnt[w][tid];
      warp_cnt[w][tid] = round_total;
      round_total += t;
    }
    __syncthreads();
    if (valid) {
      const uint32_t pos = cursor[d] + warp_cnt[warp][d] + rank;
      if (slots != nullptr) slots[i] = pos;
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) {
        if (l < lanes.count) lanes.out[l][pos] = __ldg(lanes.in[l] + i);
      }
    }
    __syncthreads();
    cursor[tid] += round_total;
  }
}

}  // namespace

extern "C" {

// Scratch the caller allocates for one pass over n keys: 256 * num_blocks
// uint32 counts plus 256 uint32 totals.
long long rj_radix_num_blocks(long long n) { return (n + kTile - 1) / kTile; }

// One digit pass.  keys: uint32 [n]; slots: uint32 [n] or null; lanes_in /
// lanes_out: arrays of `num_lanes` (<= 4) device pointers to uint32 [n]
// (host arrays of pointers); counts, totals: scratch as above.  Launches on
// `stream` and returns cudaGetLastError().
int rj_radix_pass(const void* keys, long long n, int shift, void* slots, int num_lanes,
                  const void* const* lanes_in, void* const* lanes_out, void* counts,
                  void* totals, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  if (n > 0xFFFFFFFFll || shift < 0 || shift > 24 || num_lanes < 0 ||
      num_lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const long long nb = rj_radix_num_blocks(n);
  if (nb > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  Lanes lanes;
  lanes.count = num_lanes;
  for (int l = 0; l < kMaxLanes; ++l) {
    lanes.in[l] = l < num_lanes ? static_cast<const uint32_t*>(lanes_in[l]) : nullptr;
    lanes.out[l] = l < num_lanes ? static_cast<uint32_t*>(lanes_out[l]) : nullptr;
  }
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  uint32_t* c = static_cast<uint32_t*>(counts);
  uint32_t* t = static_cast<uint32_t*>(totals);
  digit_hist_kernel<<<(unsigned)nb, kThreads, 0, st>>>(k, n, shift, c, (int)nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  digit_scan_kernel<<<kRadix, kScanThreads, 0, st>>>(c, (int)nb, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<(unsigned)nb, kThreads, 0, st>>>(k, n, shift, c, (int)nb, t,
                                                    static_cast<uint32_t*>(slots), lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
