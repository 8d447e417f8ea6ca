// K4: one stable counting pass that groups tuples by a small id.
//
// Replaces tpu_radix_join/ops/pallas/partition.py::partition_slots_pallas
// (_kernel).  Contract, for uint32 ids [n] and num_groups <= 256 groups
// (ids >= num_groups are invalid: counted nowhere and dropped):
//   * dense mode (capacity < 0): slots[i] is a stable grouping permutation
//     target -- groups in id order, input order within a group;
//   * blocked mode: group_size consecutive groups share block
//     g / group_size of `capacity` slots; slots[i] is
//     (g / group_size) * capacity + its position within the block, and a
//     tuple whose unclipped position is >= capacity gets 0xFFFFFFFF;
//   * hist[g] (totals) is the exact per-group count whether or not tuples
//     were clipped.
// The pass can also move up to four uint32 lanes to their slots itself
// (dropped tuples are not written): the caller pre-fills the outputs with
// its pad values.
//
// Bound on the H100: bytes.  A grouping must read the ids and each moved
// lane once and write each output once.  This pass reads the ids twice and
// every moved lane once, and scatters 4-byte stores that are contiguous
// within a group and a round.
//
// Design: the TPU kernel ran its grid in order and carried per-group write
// cursors in SMEM.  CUDA blocks run in no order, so the pass has K2's
// reduce-then-scan shape (csrc/radix_sort.cu) with the id as the digit:
//   1. group_hist_kernel: every block counts its tile's ids into a
//      group-major table counts[g * num_blocks + block];
//   2. group_scan_kernel: one block per group turns its row into an
//      exclusive scan and stores the group total;
//   3. scatter_kernel: every block scans the totals into group starts
//      (restarting every group_size groups in blocked mode), then ranks its
//      tile in rounds of 256 ids with __match_any_sync and per-warp counts
//      in warp order, so positions follow input order within a group.
// An id is tested against num_groups before it becomes a group index, so
// id 256 with 256 groups is dropped, not wrapped to group 0.  Positions are
// 64-bit until the clip, so an unclipped position never wraps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kGroups = 256;   // most groups one pass takes (MAX_PARTITIONS)
constexpr int kThreads = 256;  // one thread per group in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;
constexpr int kScanThreads = 1024;
constexpr int kMaxLanes = 4;
constexpr uint32_t kDropped = 0xFFFFFFFFu;

struct Lanes {
  const uint32_t* in[kMaxLanes];
  uint32_t* out[kMaxLanes];
  int count;
};

// The group of an id, or kGroups for an invalid one (tested before any
// narrowing: every uint32 id is legal input).
__device__ __forceinline__ int group_of(uint32_t id, int num_groups) {
  return id < (uint32_t)num_groups ? (int)id : kGroups;
}

__global__ void __launch_bounds__(kThreads)
group_hist_kernel(const uint32_t* __restrict__ ids, long long n, int num_groups,
                  uint32_t* __restrict__ counts, int num_blocks) {
  __shared__ uint32_t hist[kGroups];
  hist[threadIdx.x] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kThreads + threadIdx.x;
    const int g = i < n ? group_of(__ldg(ids + i), num_groups) : kGroups;
    // warp-aggregated add: one shared atomic per distinct group per warp
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    if (g < kGroups && lane == __ffs(peers) - 1) atomicAdd(hist + g, (uint32_t)__popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < num_groups)
    counts[(long long)threadIdx.x * num_blocks + blockIdx.x] = hist[threadIdx.x];
}

// One block per group: row `blockIdx.x` of counts becomes its exclusive
// scan; its total goes to totals[group].
__global__ void __launch_bounds__(kScanThreads)
group_scan_kernel(uint32_t* __restrict__ counts, int num_blocks,
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

// capacity < 0 selects dense mode.
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint32_t* __restrict__ ids, long long n, int num_groups,
               int group_size, long long capacity, const uint32_t* __restrict__ counts,
               int num_blocks, const uint32_t* __restrict__ totals,
               uint32_t* __restrict__ slots, Lanes lanes) {
  __shared__ uint32_t scratch[kWarps];
  __shared__ uint32_t group_start[kGroups];
  __shared__ unsigned long long cursor[kGroups];
  __shared__ uint32_t warp_cnt[kWarps][kGroups];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const bool dense = capacity < 0;

  // group starts: the exclusive scan of the totals, in id order
  const bool real = tid < num_groups;
  const uint32_t start = rj::block_exclusive_scan<kThreads>(
      real ? totals[tid] : 0u, 0u, rj::SumOp(), scratch, (uint32_t*)nullptr);
  group_start[tid] = start;
  __syncthreads();
  // blocked mode: the position restarts at the block's first group
  unsigned long long first = start;
  if (!dense) first = start - group_start[(tid / group_size) * group_size];
  cursor[tid] = first + (real ? counts[(long long)tid * num_blocks + blockIdx.x] : 0u);

  const long long base = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const long long row = base + (long long)r * kThreads;
    if (row >= n) break;  // uniform across the block
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_cnt[w][tid] = 0u;
    __syncthreads();
    const long long i = row + tid;
    const bool in_range = i < n;
    const int g = in_range ? group_of(__ldg(ids + i), num_groups) : kGroups;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const uint32_t rank = (uint32_t)__popc(peers & lanemask_lt);
    if (g < kGroups && rank == 0u) warp_cnt[warp][g] = (uint32_t)__popc(peers);
    __syncthreads();
    // thread `tid` owns group `tid`: exclusive prefix over warps, in warp order
    uint32_t round_total = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t t = warp_cnt[w][tid];
      warp_cnt[w][tid] = round_total;
      round_total += t;
    }
    __syncthreads();
    if (in_range) {
      uint32_t slot = kDropped;
      if (g < kGroups) {
        const unsigned long long pos = cursor[g] + warp_cnt[warp][g] + rank;
        if (dense) {
          slot = (uint32_t)pos;
        } else if (pos < (unsigned long long)capacity) {
          slot = (uint32_t)((unsigned long long)(g / group_size) * capacity + pos);
        }
      }
      if (slots != nullptr) slots[i] = slot;
      if (slot != kDropped) {
#pragma unroll
        for (int l = 0; l < kMaxLanes; ++l) {
          if (l < lanes.count) lanes.out[l][slot] = __ldg(lanes.in[l] + i);
        }
      }
    }
    __syncthreads();
    cursor[tid] += round_total;
  }
}

}  // namespace

extern "C" {

// Scratch the caller allocates for one pass over n ids: num_groups *
// num_blocks uint32 counts plus 256 uint32 totals.
long long rj_partition_num_blocks(long long n) { return (n + kTile - 1) / kTile; }

// One grouping pass.  ids: uint32 [n]; capacity < 0 for dense mode, else the
// block size, with (num_groups / group_size) * capacity <= 0xFFFFFFFF so the
// drop sentinel is never a slot; slots: uint32 [n] or null; lanes_in /
// lanes_out: host arrays of `num_lanes` (<= 4) device pointers to uint32,
// inputs [n], outputs of the layout's size; totals[g] receives hist[g] for
// g < num_groups.  Launches on `stream` and returns cudaGetLastError().
int rj_partition(const void* ids, long long n, int num_groups, int group_size,
                 long long capacity, void* slots, int num_lanes,
                 const void* const* lanes_in, void* const* lanes_out, void* counts,
                 void* totals, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > 0xFFFFFFFFll || num_groups < 1 || num_groups > kGroups ||
      group_size < 1 || num_groups % group_size != 0 || num_lanes < 0 ||
      num_lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  if (capacity >= 0 &&
      (capacity == 0 || (long long)(num_groups / group_size) * capacity > 0xFFFFFFFFll))
    return (int)cudaErrorInvalidValue;
  uint32_t* t = static_cast<uint32_t*>(totals);
  if (n == 0) {
    cudaMemsetAsync(t, 0, sizeof(uint32_t) * num_groups, st);
    return (int)cudaGetLastError();
  }
  const long long nb = rj_partition_num_blocks(n);
  if (nb > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  Lanes lanes;
  lanes.count = num_lanes;
  for (int l = 0; l < kMaxLanes; ++l) {
    lanes.in[l] = l < num_lanes ? static_cast<const uint32_t*>(lanes_in[l]) : nullptr;
    lanes.out[l] = l < num_lanes ? static_cast<uint32_t*>(lanes_out[l]) : nullptr;
  }
  const uint32_t* k = static_cast<const uint32_t*>(ids);
  uint32_t* c = static_cast<uint32_t*>(counts);
  group_hist_kernel<<<(unsigned)nb, kThreads, 0, st>>>(k, n, num_groups, c, (int)nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_scan_kernel<<<num_groups, kScanThreads, 0, st>>>(c, (int)nb, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<(unsigned)nb, kThreads, 0, st>>>(k, n, num_groups, group_size, capacity,
                                                    c, (int)nb, t,
                                                    static_cast<uint32_t*>(slots), lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
