// K4: a stable grouping of tuples by a small id, onesweep design.
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
// A call either writes the slots (slots mode) or moves up to four uint32
// lanes to them itself and writes every other slot of each output with the
// lane's fill value (dense: [valid total, n); blocked: each block's tail
// [min(count, capacity), capacity)).  Dropped tuples are never written.
//
// Bound on the H100: bytes.  A grouping must read the ids and each moved
// lane once and write each output once.  This design reads the ids twice
// (the histogram and the pass) and every moved lane once, and writes every
// output slot once.
//
// Design (K2's onesweep, csrc/radix_sort.cu, with the group id as the digit).
// The TPU kernel ran its grid in order and carried per-group write cursors in
// SMEM.  Here a call is two launches:
//   1. histogram_kernel: one wave of blocks counts the ids into per-warp
//      shared tables (a warp whose counted ids share one group adds once),
//      and adds its table into the totals with one atomic a group;
//   2. onesweep_kernel: a block takes the next tile of kTile ids from a
//      counter, so the look-back never waits on a tile that is not running.
//      It loads the ids warp-striped (lane l holds base + 32 j + l), counts
//      each warp's groups with shared atomics and publishes the tile's
//      per-group counts at once, then ranks item by item: the lanes of equal
//      group gather in a shared word by atomicOr (what __match_any_sync
//      gives, without its cost) unless the warp's ids share one group, and
//      the lowest advances the warp's counter, so positions follow input
//      order.  One thread per group resolves the group's offset by decoupled
//      look-back.  Group starts are the exclusive scan of the totals,
//      restarting every group_size groups in blocked mode.  The tile sits in
//      shared memory in (group, rank) order and every lane is written out
//      with consecutive threads on consecutive slots of each group's run.
//      After its tile, every block writes its share of the pad slots.
// An id is tested against num_groups before it becomes a group index, so
// id 256 with 256 groups is dropped, not wrapped to group 0.  Positions are
// 64-bit until the clip, so an unclipped position never wraps.  Look-back
// words are 64 bits, a flag over a 32-bit count (n < 2**32), stored and
// loaded relaxed (lookback.cuh).  The look-back gives each group 256 /
// num_groups lanes (at most 32), each reading kLookBack words a round, so
// one group reaches 256 tiles back in a round and 256 groups 8.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it): the moving pass 64
// registers (four blocks an SM), 46,188 bytes of shared memory, 52 bytes
// spilled; the slots pass 62 registers, 27,684 bytes; the histogram 48
// registers, 8,192 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "lookback.cuh"

namespace {

constexpr int kGroups = 256;   // most groups one pass takes (MAX_PARTITIONS)
constexpr int kThreads = 256;  // thread `tid` owns group `tid` in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;     // ids a thread holds
constexpr int kMinBlocks = 4;  // blocks an SM keeps: at most 64 registers a thread
constexpr int kLookBack = 8;   // look-back words a thread reads at once
constexpr int kWarpIds = 32 * kItems;
constexpr int kTile = kThreads * kItems;  // TILE_IDS in ops/kernels/partition.py
constexpr int kSlotBits = 13;  // a local slot < kTile
constexpr int kMaxLanes = 4;
constexpr int kHistThreads = kGroups;  // one thread per group at the flush
constexpr int kHistItems = 8;          // 16-byte loads a histogram thread takes a round
constexpr long long kPadSlots = 4 * kTile;  // pad slots a block writes at most, roughly
constexpr uint32_t kDropped = 0xFFFFFFFFu;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint32_t kAggregate = 1u;  // look-back status, high word
constexpr uint32_t kInclusive = 2u;
static_assert(kTile <= (1 << kSlotBits), "a local slot fits kSlotBits");

struct Lanes {
  const uint32_t* in[kMaxLanes];
  uint32_t* out[kMaxLanes];
  uint32_t fill[kMaxLanes];
};

// The group of an id, or kGroups for an invalid one (tested before any
// narrowing: every uint32 id is legal input).
__device__ __forceinline__ int group_of(uint32_t id, int num_groups) {
  return id < (uint32_t)num_groups ? (int)id : kGroups;
}

__device__ __forceinline__ void publish(unsigned long long* p, uint32_t flag, uint32_t count) {
  rj::store_relaxed(p, ((unsigned long long)flag << 32) | (unsigned long long)count);
}

// Adds one to hist[g] for every lane whose g is a group (< kGroups).  A warp
// whose counted lanes share one group adds once: one-group inputs (one
// destination, pad runs) would otherwise serialise 32 lanes on one word.
// Every lane of the warp calls it.
__device__ __forceinline__ void count_group(int g, uint32_t* hist) {
  const int lane = threadIdx.x & 31;
  const bool counted = g < kGroups;
  const unsigned lanes = __ballot_sync(0xffffffffu, counted);
  if (lanes == 0u) return;
  const int first = __ffs(lanes) - 1;
  const int g0 = __shfl_sync(0xffffffffu, g, first);
  if (__all_sync(0xffffffffu, !counted || g == g0)) {
    if (lane == first) atomicAdd(hist + g0, (uint32_t)__popc(lanes));
  } else if (counted) {
    atomicAdd(hist + g, 1u);
  }
}

__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(const uint32_t* __restrict__ ids, long long n, int num_groups,
                 uint32_t* __restrict__ totals) {
  __shared__ uint32_t hist[kWarps][kGroups];
  const int tid = threadIdx.x;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) hist[w][tid] = 0u;
  __syncthreads();
  uint32_t* mine = hist[tid >> 5];
  // 16-byte loads over the aligned body, 4-byte loads over the rest; the
  // loop bounds are uniform across the block, as the warp votes need
  const long long nvec = ((uintptr_t)ids & 15u) == 0 ? n / 4 : 0;
  const uint4* vec = reinterpret_cast<const uint4*>(ids);
  const long long stride = (long long)gridDim.x * kHistThreads * kHistItems;
  for (long long b = (long long)blockIdx.x * kHistThreads * kHistItems; b < nvec; b += stride) {
    uint4 q[kHistItems];
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      const long long v = b + (long long)j * kHistThreads + tid;
      q[j] = v < nvec ? __ldg(vec + v) : make_uint4(kInvalid, kInvalid, kInvalid, kInvalid);
    }
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      count_group(group_of(q[j].x, num_groups), mine);
      count_group(group_of(q[j].y, num_groups), mine);
      count_group(group_of(q[j].z, num_groups), mine);
      count_group(group_of(q[j].w, num_groups), mine);
    }
  }
  for (long long b = 4 * nvec + (long long)blockIdx.x * kHistThreads; b < n;
       b += (long long)gridDim.x * kHistThreads) {
    const long long i = b + tid;
    count_group(i < n ? group_of(__ldg(ids + i), num_groups) : kGroups, mine);
  }
  __syncthreads();
  if (tid < num_groups) {
    uint32_t c = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w][tid];
    if (c != 0u) atomicAdd(totals + tid, c);
  }
}

// The slot of a tuple of group g at unclipped position pos within its layout
// block (dense: within the whole output), or kDropped past the capacity.
__device__ __forceinline__ uint32_t slot_of(long long pos, int g, int group_size,
                                            long long capacity) {
  if (capacity < 0) return (uint32_t)pos;
  if (pos >= capacity) return kDropped;
  return (uint32_t)((long long)(g / group_size) * capacity + pos);
}

// capacity < 0 selects dense mode.  kSlots: write slots[n] and move nothing;
// else move lanes.in -> lanes.out and write the pads.
template <bool kSlots>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
onesweep_kernel(const uint32_t* __restrict__ ids, long long n, int num_groups, int group_size,
                long long capacity, long long num_tiles, uint32_t* __restrict__ slots,
                Lanes lanes, int num_lanes, const uint32_t* __restrict__ totals,
                unsigned long long* __restrict__ lookback, uint32_t* __restrict__ tile_counter) {
  __shared__ uint32_t stage[kTile];  // the tile in (group, rank) order
  __shared__ uint32_t warp_base[kWarps][kGroups];
  __shared__ uint32_t lanes_of[2][kWarps][kGroups];  // per item: lanes holding a group
  __shared__ long long rel_base[kGroups];  // unclipped position - local slot, per group
  __shared__ uint32_t before_group[kGroups];  // ids of the group in the tiles before
  __shared__ unsigned long long pad_before[kGroups + 1];  // pads of the regions before
  __shared__ uint32_t scratch[kWarps];
  __shared__ unsigned long long scratch64[kWarps];
  __shared__ uint32_t tile_shared;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const bool dense = capacity < 0;
  const int regions = dense ? 1 : num_groups / group_size;  // pad regions
  int sub = 32;  // look-back lanes a group: 256 / num_groups rounded, at most 32
  while (sub > 1 && sub * num_groups > kThreads) sub >>= 1;

  if (tid == 0) tile_shared = atomicAdd(tile_counter, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    warp_base[w][tid] = 0u;
    lanes_of[0][w][tid] = 0u;
    lanes_of[1][w][tid] = 0u;
  }
  // group starts: the exclusive scan of the totals, in id order
  const bool real = tid < num_groups;
  uint32_t valid_total;
  const uint32_t start = rj::block_exclusive_scan<kThreads>(
      real ? totals[tid] : 0u, 0u, rj::SumOp(), scratch, &valid_total);
  rel_base[tid] = start;  // for now: the group starts
  __syncthreads();
  // blocked mode: the position restarts at the block's first group
  const long long start_rel =
      dense ? (long long)start : (long long)start - rel_base[(tid / group_size) * group_size];
  if (!kSlots && num_lanes > 0) {
    // the pad slots of region tid: a layout block's count runs from the
    // start of its first group to that of the next block's (the valid
    // total past the last)
    unsigned long long pads = 0ull;
    if (!dense && tid < regions) {
      const int first = tid * group_size;
      const long long next = first + group_size < num_groups ? rel_base[first + group_size]
                                                             : (long long)valid_total;
      const long long count = next - rel_base[first];
      pads = (unsigned long long)(capacity - (count < capacity ? count : capacity));
    } else if (dense && tid == 0) {
      pads = (unsigned long long)(n - (long long)valid_total);
    }
    unsigned long long pad_total;
    const unsigned long long pad_excl = rj::block_exclusive_scan<kThreads>(
        pads, 0ull, rj::SumOp(), scratch64, &pad_total);
    if (tid < regions) pad_before[tid] = pad_excl;
    if (tid == 0) pad_before[regions] = pad_total;
  }

  const uint32_t tile = tile_shared;
  if ((long long)tile < num_tiles) {  // block-uniform
    const long long tile_start = (long long)tile * kTile;
    const long long warp_start = tile_start + (long long)warp * kWarpIds;
    const bool full = tile_start + kTile <= n;  // no row past n: every lane in range

    uint32_t grp[kItems];  // group, kGroups for an invalid id or a row past n
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = warp_start + 32 * j + lane;
      grp[j] = (full || i < n) ? (uint32_t)group_of(__ldg(ids + i), num_groups) : kGroups;
    }
    // each warp's group counts first, so the tile's counts are published
    // before the ranking
    uint32_t* counter = warp_base[warp];
#pragma unroll
    for (int j = 0; j < kItems; ++j) count_group((int)grp[j], counter);
    __syncthreads();

    // each group's count in the tile, published at once; the warps'
    // exclusive prefix and the group's start in the tile
    uint32_t count = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_base[w][tid];
      warp_base[w][tid] = count;
      count += c;
    }
    unsigned long long* mine = lookback + (long long)tile * num_groups + tid;
    if (real) publish(mine, tile == 0u ? kInclusive : kAggregate, count);
    uint32_t tile_n;  // ids of the tile that rank
    const uint32_t local_start = rj::block_exclusive_scan<kThreads>(
        count, 0u, rj::SumOp(), scratch, &tile_n);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_base[w][tid] += local_start;
    __syncthreads();

    // rank item by item: an id's local slot is its warp's next slot for its
    // group plus the lanes below with that group, so slots follow input
    // order within a group.  A warp whose ranked lanes share one group knows
    // its peers from the ballot; otherwise the lanes of equal group gather
    // in a shared word by atomicOr, and the lowest of them advances the
    // counter and clears the word, which item j + 2 uses again.
    // info = group << kSlotBits | slot, or kInvalid.
    uint32_t info[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int g = (int)grp[j];
      const bool valid = g < kGroups;
      const unsigned valid_lanes = __ballot_sync(0xffffffffu, valid);
      unsigned peers = 0u;
      if (valid_lanes != 0u) {
        const int g0 = __shfl_sync(0xffffffffu, g, __ffs(valid_lanes) - 1);
        if (__all_sync(0xffffffffu, !valid || g == g0)) {
          peers = valid ? valid_lanes : 0u;
        } else {
          uint32_t* word = &lanes_of[j & 1][warp][valid ? g : 0];
          if (valid) atomicOr(word, 1u << lane);
          __syncwarp();
          peers = valid ? *word : 0u;
          __syncwarp();
          if (valid && lane == __ffs(peers) - 1) *word = 0u;
        }
      }
      __syncwarp();  // the counters' and the words' last writes come first
      const int leader = __ffs(peers) - 1;
      uint32_t next = 0u;
      if (valid && lane == leader) {
        next = counter[g];
        counter[g] = next + (uint32_t)__popc(peers);
      }
      const uint32_t slot = __shfl_sync(0xffffffffu, next, leader < 0 ? 0 : leader) +
                            (uint32_t)__popc(peers & lanemask_lt);
      if (valid) {
        if (!kSlots) stage[slot] = (uint32_t)g;
        info[j] = ((uint32_t)g << kSlotBits) | slot;
      } else {
        info[j] = kInvalid;
      }
    }

    // decoupled look-back: the ids of each group in the tiles before this
    // one.  `sub` lanes of one warp share a group (32 for up to 8 groups, 8
    // for 32, 1 for 256), each reading kLookBack words a round, so a round
    // reaches sub * kLookBack tiles back; a lane's words run back from tile
    // t, and lanes further along the group's lanes read further back.  The
    // loops are warp-uniform, as the votes need.
    {
      const int lg = tid / sub;  // the group this thread looks back for
      const int sl = tid % sub;  // its lane among the group's lanes
      const unsigned sub_mask = sub == 32 ? 0xffffffffu : ((1u << sub) - 1u) << (lane & ~(sub - 1));
      bool done = !(lg < num_groups && tile > 0u);
      uint32_t acc = 0u;
      long long t = (long long)tile - 1 - (long long)sl * kLookBack;
      while (__any_sync(0xffffffffu, !done)) {
        unsigned long long w[kLookBack];
        bool ready;
        do {  // wait until every word of the round is published
          ready = true;
#pragma unroll
          for (int k = 0; k < kLookBack; ++k) {
            const bool read = !done && t - k >= 0;
            w[k] = read ? rj::load_relaxed(lookback + (t - k) * num_groups + lg) : 0ull;
            if (read && (w[k] >> 32) == 0ull) ready = false;
          }
        } while (!__all_sync(0xffffffffu, ready));
        // this lane's counts up to its first inclusive word; the group's
        // lanes up to the first that holds one
        uint32_t part = 0u;
        bool incl = false;
#pragma unroll
        for (int k = 0; k < kLookBack; ++k) {
          if (!incl) {
            part += (uint32_t)w[k];
            incl = ((uint32_t)(w[k] >> 32) & kInclusive) != 0u;
          }
        }
        const unsigned incl_lanes = __ballot_sync(0xffffffffu, incl) & sub_mask;
        const int first = incl_lanes != 0u ? __ffs(incl_lanes) - 1 : 32;
        uint32_t v = lane <= first ? part : 0u;
        for (int o = 1; o < sub; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (!done) {
          acc += v;
          done = incl_lanes != 0u;
          t -= (long long)sub * kLookBack;
        }
      }
      if (lg < num_groups && sl == 0) before_group[lg] = acc;
    }
    __syncthreads();
    const uint32_t before_tile = real ? before_group[tid] : 0u;
    if (real && tile > 0u) publish(mine, kInclusive, before_tile + count);
    rel_base[tid] = start_rel + (long long)before_tile - (long long)local_start;
    __syncthreads();

    constexpr uint32_t kSlotMask = (1u << kSlotBits) - 1u;
    if (kSlots) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long i = warp_start + 32 * j + lane;
        if (!(full || i < n)) continue;
        uint32_t s = kDropped;
        if (info[j] != kInvalid) {
          const int g = (int)(info[j] >> kSlotBits);
          s = slot_of(rel_base[g] + (long long)(info[j] & kSlotMask), g, group_size, capacity);
        }
        slots[i] = s;
      }
    } else if (num_lanes > 0) {
      // the destination of every staged id: consecutive threads,
      // consecutive slots of each group's run
      uint32_t dst[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int i = r * kThreads + tid;
        dst[r] = kDropped;
        if (i < (int)tile_n) {
          const int g = (int)stage[i];
          dst[r] = slot_of(rel_base[g] + i, g, group_size, capacity);
        }
      }
      // every lane through the stage: a warp-striped load, a store at the
      // id's local slot, a write in (group, rank) order
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) {
        if (l >= num_lanes) break;
        const uint32_t* in = lanes.in[l];
        uint32_t* out = lanes.out[l];
        uint32_t v[kItems];
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          v[j] = info[j] != kInvalid ? __ldg(in + warp_start + 32 * j + lane) : 0u;
        __syncthreads();  // the stage's previous contents are read
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          if (info[j] != kInvalid) stage[info[j] & kSlotMask] = v[j];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kItems; ++r) {
          if (dst[r] != kDropped) out[dst[r]] = stage[r * kThreads + tid];
        }
      }
    }
  }
  if (kSlots || num_lanes == 0) return;

  // the pads: this block's share [lo, hi) of the pad slots, which run
  // region by region; region b ends at (b + 1) * capacity (dense: at n)
  __syncthreads();  // pad_before is written
  const unsigned long long total = pad_before[regions];
  const unsigned long long share = (total + gridDim.x - 1) / gridDim.x;
  const unsigned long long lo = (unsigned long long)blockIdx.x * share;
  const unsigned long long hi = lo + share < total ? lo + share : total;
  for (int b = 0; b < regions && lo < hi; ++b) {
    const unsigned long long pb = pad_before[b];
    const unsigned long long pe = pad_before[b + 1];
    if (pe <= lo || pb >= hi) continue;
    const unsigned long long end = dense ? (unsigned long long)n
                                         : (unsigned long long)(b + 1) * capacity;
    const unsigned long long first = end - (pe - pb);  // the region's first pad slot
    const unsigned long long from = (lo > pb ? lo : pb) - pb;
    const unsigned long long to = (hi < pe ? hi : pe) - pb;
    for (unsigned long long x = from + tid; x < to; x += kThreads) {
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) {
        if (l >= num_lanes) break;
        lanes.out[l][first + x] = lanes.fill[l];
      }
    }
  }
}

}  // namespace

extern "C" {

// One grouping call.  ids: uint32 [n]; capacity < 0 for dense mode, else the
// block size, with (num_groups / group_size) * capacity <= 0xFFFFFFFF so the
// drop sentinel is never a slot.  slots != null: writes uint32 slots[n] and
// moves nothing.  slots == null: moves num_lanes (<= 4) lanes from
// lanes_in (host array of device pointers to uint32 [n]) to lanes_out
// (outputs of the layout's size) and writes every other output slot with
// fills[lane].  scratch: one block of scratch_bytes = 8 * num_tiles *
// num_groups + 4 * 256 + 8 bytes (num_tiles = ceil(n / TILE_IDS)): the
// look-back table, the 256 uint32 totals (hist[g] for g < num_groups) and
// the tile counter, zeroed here with one memset.  Launches the histogram
// and the onesweep kernel on `stream` and returns cudaGetLastError().
int rj_partition(const void* ids, long long n, int num_groups, int group_size,
                 long long capacity, void* slots, int num_lanes, const void* const* lanes_in,
                 void* const* lanes_out, const unsigned* fills, void* scratch,
                 long long scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > 0xFFFFFFFFll || num_groups < 1 || num_groups > kGroups ||
      group_size < 1 || num_groups % group_size != 0 || num_lanes < 0 ||
      num_lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  if (capacity >= 0 &&
      (capacity == 0 || (long long)(num_groups / group_size) * capacity > 0xFFFFFFFFll))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long lookback_words = tiles * num_groups;
  if (scratch_bytes != 8 * lookback_words + 4 * kGroups + 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)scratch_bytes, st);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* lookback = static_cast<unsigned long long*>(scratch);
  uint32_t* totals = reinterpret_cast<uint32_t*>(lookback + lookback_words);
  uint32_t* counter = totals + kGroups;
  const uint32_t* k = static_cast<const uint32_t*>(ids);
  if (n > 0) {
    // one wave of blocks, each striding over the ids
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel, kHistThreads, 0);
    const long long per_block = (long long)kHistThreads * kHistItems * 4;
    long long blocks = (n + per_block - 1) / per_block;
    const long long wave = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (blocks > wave) blocks = wave;
    histogram_kernel<<<(unsigned)blocks, kHistThreads, 0, st>>>(k, n, num_groups, totals);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (slots != nullptr) {
    if (tiles == 0) return (int)cudaGetLastError();
    onesweep_kernel<true><<<(unsigned)tiles, kThreads, 0, st>>>(
        k, n, num_groups, group_size, capacity, tiles, static_cast<uint32_t*>(slots), Lanes{},
        0, totals, lookback, counter);
    return (int)cudaGetLastError();
  }
  Lanes lanes{};
  for (int l = 0; l < num_lanes; ++l) {
    lanes.in[l] = static_cast<const uint32_t*>(lanes_in[l]);
    lanes.out[l] = static_cast<uint32_t*>(lanes_out[l]);
    lanes.fill[l] = fills[l];
  }
  // enough blocks that none writes much more than kPadSlots pad slots
  const long long out_size = capacity < 0 ? n : (long long)(num_groups / group_size) * capacity;
  long long blocks = tiles;
  if (num_lanes > 0 && (out_size + kPadSlots - 1) / kPadSlots > blocks)
    blocks = (out_size + kPadSlots - 1) / kPadSlots;
  if (blocks == 0) return (int)cudaGetLastError();
  onesweep_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
      k, n, num_groups, group_size, capacity, tiles, nullptr, lanes, num_lanes, totals, lookback,
      counter);
  return (int)cudaGetLastError();
}

}  // extern "C"
