// K4 past its 256 groups: one grouping kernel for up to 8192 groups.
//
// Replaces tpu_radix_join/ops/pallas/partition.py::partition_slots_pallas
// (_kernel) where 256 < num_groups <= 8192, the fanouts the TPU kernel's SMEM
// cursors never held (the JAX package falls back to its sort arm there).
// The contract is K4's (partition.cu): for uint32 ids [n], n < 2**32, ids >=
// num_groups are invalid: counted nowhere and dropped; dense mode
// (capacity < 0) gives a stable grouping permutation (groups in id order,
// input order within a group); blocked mode gives group_size consecutive
// groups a block of `capacity` slots, and a tuple whose unclipped position in
// its block is >= capacity gets 0xFFFFFFFF, so the clip eats a block's
// highest groups first; the totals are exact whether or not tuples were
// clipped.  A call writes slots[n] (slots mode) or moves up to four uint32
// lanes and writes every other output slot with the lane's fill (dense
// [valid total, n), blocked each block's tail [min(count, capacity),
// capacity)).  Past 8192 groups the LSD composition (partition_lsd.cu) runs.
//
// Bound on the H100: bytes.  A grouping must read the ids and each moved lane
// once and write each output once.  This design reads the ids twice, each
// lane once, and writes each output once, plus its count matrix (16-bit tile
// rows, 32-bit chunk words; ops/kernels/partition.py's wide_scratch_layout):
// at 20M ids 7.5 MB at 1025 groups and 30 MB at 4097, written and read
// again, about 4% and 15% of the 400 MB that two moved lanes need.
//
// Design: reduce, scan, then one stable scattering sweep.  The TPU kernel
// ran its grid in order and carried per-group cursors in SMEM; the onesweep
// of partition.cu gives thread `tid` group `tid` and a look-back word a tile
// and group, which does not grow to thousands of groups.  Here a call is four
// launches and no spin-wait:
//   1. count_kernel: a block takes a chunk of kChunk tiles of kTile ids and
//      counts them into one shared table of num_groups counters (a warp whose
//      ids share a group adds once).  Before each tile it writes the table,
//      the counts of the chunk's earlier tiles, as the tile's 16-bit row
//      (coalesced, group-major within the row), and after the chunk the
//      chunk's counts as a 32-bit row.
//   2. carry_kernel: a block of 32 groups x 32 chunk lanes; each lane sums a
//      contiguous run of chunks for its group, the lanes' exclusive prefix
//      comes from shared memory, and each lane rewrites its chunk words as
//      the group's ids in the chunks before; the last lane writes the exact
//      total (hist).
//   3. starts_kernel (one block): the group starts, the exclusive scan of the
//      totals, and the pad slots of each layout region before it, 64-bit.
//   4. sweep_kernel: a block takes tile `blockIdx.x`, gives every id its group
//      (num_groups for an invalid id or a row past n) and sorts the tile
//      stably in shared memory by two 8-bit LSD digit passes of (group << 13
//      | local index): in each pass a warp ranks its 16 x 32 warp-striped
//      items in input order (the lanes of one digit found by a ballot a
//      digit bit),
//      per-warp digit counts scan digit-major across the 16 warps, and every
//      item lands at its digit's offset plus its rank.  Every group's base
//      (its start, plus its chunk word and tile row, less its block's start
//      in blocked mode) is loaded at the tile's start, coalesced and in
//      flight with the ids; the first item of each group in the sorted tile
//      takes its sorted index off it, so an item's position in its block is
//      the base plus its sorted index.  Slots mode stages each id's slot at
//      its input index and writes slots[] in input order; the moving mode
//      keeps the inverse permutation, stages each lane (a coalesced load, a
//      store at the id's sorted index) and writes it with consecutive
//      threads on consecutive slots of each group's run.  Every block then
//      writes its share of the pad slots.
// Positions: every unclipped position and block offset lies in [0, n) and n <
// 2**32, so a base is kept modulo 2**32 and base + index is exact; the clip
// compares in 64 bits.  A tile row is at most (kChunk - 1) * kTile < 2**16.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it): the moving sweep 64
// registers (two blocks an SM), 72 bytes spilled; the slots sweep 64
// registers, 68 bytes spilled; each 49,152 + 4 * (num_groups + 1) bytes of
// dynamic shared memory (81,924 at 8192 groups); the count launch 32
// registers, 32,768 bytes; the carry 32 registers, 4,224 bytes; the starts
// 32 registers, 384 bytes; no other spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kMaxGroups = 8192;  // WIDE_MAX_GROUPS in ops/kernels/partition.py
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // ids a thread holds
constexpr int kTile = kThreads * kItems;  // WIDE_TILE_IDS
constexpr int kIndexBits = 13;            // a local index < kTile
constexpr int kChunk = 4;                 // tiles a count block takes (WIDE_CHUNK_TILES)
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kCarryLanes = 32;  // chunk lanes of a carry block
constexpr int kScanThreads = 1024;
constexpr int kMaxLanes = 4;
constexpr long long kPadSlots = 4 * kTile;  // pad slots a block writes at most, roughly
constexpr uint32_t kDropped = 0xFFFFFFFFu;
constexpr uint32_t kIndexMask = (1u << kIndexBits) - 1u;
static_assert(kTile == 1 << kIndexBits, "a local index fills kIndexBits");
static_assert((kMaxGroups + 1) < (1 << (2 * kDigitBits)), "two digits hold every group");
static_assert((kChunk - 1) * kTile < (1 << 16), "a tile row fits 16 bits");
static_assert(kThreads == 2 * kBins && kWarps % 2 == 0,
              "the counters' scan: a digit and half its warps a thread");

// dynamic shared memory of the sweep: the tile (packed words, then slots or a
// staged lane), the digit counters or the inverse permutation, the bases
constexpr int kStageBytes = 4 * kTile;
constexpr int kUnionBytes = 4 * kBins * kWarps;
constexpr int kMaxSweepBytes = kStageBytes + kUnionBytes + 4 * (kMaxGroups + 1);
static_assert(kUnionBytes >= 2 * kTile, "the inverse permutation fits the counters");

struct Lanes {
  const uint32_t* in[kMaxLanes];
  uint32_t* out[kMaxLanes];
  uint32_t fill[kMaxLanes];
};

// Adds one to table[g] for every lane whose g is a group (< num_groups).  A
// warp whose counted lanes share one group adds once.  Every lane calls it.
__device__ __forceinline__ void count_group(uint32_t g, uint32_t num_groups, uint32_t* table) {
  const int lane = threadIdx.x & 31;
  const bool counted = g < num_groups;
  const unsigned lanes = __ballot_sync(0xffffffffu, counted);
  if (lanes == 0u) return;
  const int first = __ffs(lanes) - 1;
  const uint32_t g0 = __shfl_sync(0xffffffffu, g, first);
  if (__all_sync(0xffffffffu, !counted || g == g0)) {
    if (lane == first) atomicAdd(table + g0, (uint32_t)__popc(lanes));
  } else if (counted) {
    atomicAdd(table + g, 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint32_t* __restrict__ ids, long long n, int num_groups, long long tiles,
             uint16_t* __restrict__ rows, uint32_t* __restrict__ chunk_words) {
  __shared__ uint32_t table[kMaxGroups];
  const int tid = threadIdx.x;
  const uint32_t groups = (uint32_t)num_groups;
  for (int g = tid; g < num_groups; g += kThreads) table[g] = 0u;
  const long long first_tile = (long long)blockIdx.x * kChunk;
  const long long last_tile = first_tile + kChunk < tiles ? first_tile + kChunk : tiles;
  for (long long t = first_tile; t < last_tile; ++t) {
    __syncthreads();  // the table holds the chunk's tiles before t
    uint16_t* row = rows + t * num_groups;
    for (int g = tid; g < num_groups; g += kThreads) row[g] = (uint16_t)table[g];
    __syncthreads();
    const long long base = t * kTile;
    const bool full = base + kTile <= n;
    uint32_t grp[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = base + (long long)j * kThreads + tid;
      grp[j] = (full || i < n) ? __ldg(ids + i) : kDropped;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) count_group(grp[j], groups, table);
  }
  __syncthreads();
  uint32_t* words = chunk_words + (long long)blockIdx.x * num_groups;
  for (int g = tid; g < num_groups; g += kThreads) words[g] = table[g];
}

// Block (32 groups) x (kCarryLanes chunk lanes): chunk_words[c][g] becomes the
// group's ids in chunks before c; totals[g] its ids in all.
__global__ void __launch_bounds__(32 * kCarryLanes)
carry_kernel(uint32_t* __restrict__ chunk_words, long long chunks, int num_groups,
             uint32_t* __restrict__ totals) {
  __shared__ uint32_t part[kCarryLanes][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int g = blockIdx.x * 32 + tx;
  const bool real = g < num_groups;
  const long long per = (chunks + kCarryLanes - 1) / kCarryLanes;
  const long long lo = (long long)ty * per;
  const long long hi = lo + per < chunks ? lo + per : chunks;
  uint32_t sum = 0u;
  if (real) {
#pragma unroll 4
    for (long long c = lo; c < hi; ++c) sum += chunk_words[c * num_groups + g];
  }
  part[ty][tx] = sum;
  __syncthreads();
  uint32_t run = 0u;
  for (int y = 0; y < ty; ++y) run += part[y][tx];
  if (real) {
    if (ty == kCarryLanes - 1) totals[g] = run + sum;
    for (long long c = lo; c < hi; ++c) {
      uint32_t* w = chunk_words + c * num_groups + g;
      const uint32_t v = *w;
      *w = run;
      run += v;
    }
  }
}

// One block: starts[g] for g <= num_groups (starts[num_groups] = the valid
// total), then, when pads are written, pad_before[b] for b <= regions: the pad
// slots of the layout regions before b (dense: one region [valid total, n)).
__global__ void __launch_bounds__(kScanThreads)
starts_kernel(const uint32_t* __restrict__ totals, int num_groups, int group_size,
              long long capacity, long long n, bool pads, uint32_t* __restrict__ starts,
              unsigned long long* __restrict__ pad_before) {
  __shared__ uint32_t scratch[kScanThreads / 32];
  __shared__ unsigned long long scratch64[kScanThreads / 32];
  const int tid = threadIdx.x;
  uint32_t carry = 0u;
  for (int base = 0; base <= num_groups; base += kScanThreads) {  // block-uniform
    const int g = base + tid;
    uint32_t total;
    const uint32_t excl = rj::block_exclusive_scan<kScanThreads>(
        g < num_groups ? totals[g] : 0u, 0u, rj::SumOp(), scratch, &total);
    if (g <= num_groups) starts[g] = carry + excl;
    carry += total;
  }
  if (!pads) return;
  __syncthreads();  // the starts are visible to the block
  const bool dense = capacity < 0;
  const int regions = dense ? 1 : num_groups / group_size;
  unsigned long long carry64 = 0ull;
  for (int base = 0; base < regions; base += kScanThreads) {  // block-uniform
    const int b = base + tid;
    unsigned long long p = 0ull;
    if (b < regions) {
      if (dense) {
        p = (unsigned long long)(n - (long long)starts[num_groups]);
      } else {
        const long long count = (long long)starts[(b + 1) * group_size] - starts[b * group_size];
        p = (unsigned long long)(capacity - (count < capacity ? count : capacity));
      }
    }
    unsigned long long total;
    const unsigned long long excl =
        rj::block_exclusive_scan<kScanThreads>(p, 0ull, rj::SumOp(), scratch64, &total);
    if (b < regions) pad_before[b] = carry64 + excl;
    carry64 += total;
  }
  if (tid == 0) pad_before[regions] = carry64;
}

// The lanes of a warp whose digit equals d (its low `bits` bits), from one
// ballot a bit.  tools_k4_wide_variants.py times the alternatives on the
// card, slower at most shapes: an atomicOr of each lane's bit into a shared
// word a digit (partition.cu's warp match), __match_any_sync, and a raking
// sort (each thread counting 16 consecutive words' 5-bit digits into its
// own column of 16-bit counters).
__device__ __forceinline__ unsigned digit_peers(uint32_t d, int bits) {
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool one = (d >> b) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, one);
    peers &= one ? m : ~m;
  }
  return peers;
}

// One stable LSD digit pass over the tile's packed words w[] (item j of warp
// `warp` is the tile's (warp * 16 + j) * 32 + lane-th word in the current
// order): every word lands at stage[its digit's offset + its rank].  count:
// kWarps x kBins counters.  Every thread calls it; it synchronises.
__device__ __forceinline__ void digit_pass(const uint32_t (&w)[kItems], int shift, int bits,
                                           uint32_t* stage, uint32_t* count) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  uint32_t* mine = count + warp * kBins;
#pragma unroll
  for (int k = 0; k < kBins * kWarps / kThreads; ++k) count[k * kThreads + tid] = 0u;
  __syncthreads();
  uint32_t rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = (w[j] >> shift) & (kBins - 1u);
    const unsigned peers = digit_peers(d, bits);
    rank[j] = mine[d] + (uint32_t)__popc(peers & lanemask_lt);
    __syncwarp();
    if (lane == __ffs(peers) - 1) mine[d] += (uint32_t)__popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // the counters' exclusive scan, digit-major then warp: thread tid holds
  // digit tid / 2 and warps (tid % 2) * 8 .. + 8
  {
    constexpr int kPer = kWarps / 2;
    const int d = tid >> 1;
    const int w0 = (tid & 1) * kPer;
    uint32_t sum = 0u;
#pragma unroll
    for (int k = 0; k < kPer; ++k) sum += count[(w0 + k) * kBins + d];
    __shared__ uint32_t scan_scratch[kThreads / 32];
    uint32_t run = rj::block_exclusive_scan<kThreads>(sum, 0u, rj::SumOp(), scan_scratch,
                                                      (uint32_t*)nullptr);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      uint32_t* c = count + (w0 + k) * kBins + d;
      const uint32_t v = *c;
      *c = run;
      run += v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = (w[j] >> shift) & (kBins - 1u);
    stage[mine[d] + rank[j]] = w[j];
  }
  __syncthreads();
}

// capacity < 0 selects dense mode.  kSlots: write slots[n]; else move lanes
// and write the pads.
template <bool kSlots>
__global__ void __launch_bounds__(kThreads, 2)
sweep_kernel(const uint32_t* __restrict__ ids, long long n, int num_groups, int group_size,
             long long capacity, long long tiles, uint32_t* __restrict__ slots, Lanes lanes,
             int num_lanes, const uint16_t* __restrict__ rows,
             const uint32_t* __restrict__ chunk_words, const uint32_t* __restrict__ starts,
             const unsigned long long* __restrict__ pad_before) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
  uint32_t* count = reinterpret_cast<uint32_t*>(smem + kStageBytes);
  uint16_t* inverse = reinterpret_cast<uint16_t*>(smem + kStageBytes);
  uint32_t* base = reinterpret_cast<uint32_t*>(smem + kStageBytes + kUnionBytes);
  if (!kSlots && num_lanes == 0) return;  // the totals are the carry's
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t groups = (uint32_t)num_groups;
  const bool dense = capacity < 0;
  const long long tile = blockIdx.x;
  if (tile < tiles) {  // block-uniform
    const long long tile_start = tile * kTile;
    const bool full = tile_start + kTile <= n;
    // warp-striped: item j of warp w is the tile's id (w * kItems + j) * 32 + lane
    uint32_t w[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = tile_start + (warp * kItems + j) * 32 + lane;
      w[j] = (full || i < n) ? __ldg(ids + i) : groups;
    }
    // every group's first position in the tile (its start, its chunk word,
    // its tile row; in blocked mode less its block's start): coalesced
    // loads, in flight with the ids'
    const long long chunk = tile / kChunk;
#pragma unroll 4
    for (int g = tid; g < num_groups; g += kThreads) {
      const uint32_t lead = dense ? 0u : starts[(g / group_size) * group_size];
      base[g] = starts[g] + chunk_words[chunk * num_groups + g] +
                (uint32_t)rows[tile * num_groups + g] - lead;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t k = (uint32_t)((warp * kItems + j) * 32 + lane);
      w[j] = ((w[j] < groups ? w[j] : groups) << kIndexBits) | k;
    }
    const int high_bits = 32 - __clz((int)(groups >> kDigitBits));  // 0 below 256 groups
    digit_pass(w, kIndexBits, kDigitBits, stage, count);
#pragma unroll
    for (int j = 0; j < kItems; ++j) w[j] = stage[(warp * kItems + j) * 32 + lane];
    __syncthreads();  // every word is read before the pass rewrites the stage
    digit_pass(w, kIndexBits + kDigitBits, high_bits, stage, count);

    // the stage holds (group, local index) sorted; thread tid takes sorted
    // indices r * kThreads + tid.  The first of each group takes its sorted
    // index off the group's base, so a position is the base plus the index.
    uint32_t word[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int s = r * kThreads + tid;
      word[r] = stage[s];
      const uint32_t g = word[r] >> kIndexBits;
      if (g < groups && (s == 0 || (stage[s - 1] >> kIndexBits) != g)) base[g] -= (uint32_t)s;
    }
    __syncthreads();  // the bases are final, the stage is read
    uint32_t dst[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int s = r * kThreads + tid;
      const uint32_t g = word[r] >> kIndexBits;
      dst[r] = kDropped;
      if (g < groups) {
        const uint32_t pos = base[g] + (uint32_t)s;  // exact: < n
        if (dense) {
          dst[r] = pos;
        } else if ((long long)pos < capacity) {
          dst[r] = (uint32_t)((long long)(g / (uint32_t)group_size) * capacity + pos);
        }
      }
      if (kSlots) {
        stage[word[r] & kIndexMask] = dst[r];
      } else {
        inverse[word[r] & kIndexMask] = (uint16_t)s;
      }
    }
    __syncthreads();
    if (kSlots) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const long long i = tile_start + (long long)r * kThreads + tid;
        if (full || i < n) slots[i] = stage[r * kThreads + tid];
      }
      return;
    }
    // every lane through the stage: a coalesced load, a store at the id's
    // sorted index, a write in (group, rank) order.  (Issuing the next lane's
    // loads before this one is written spills more of the 64 registers and
    // is slower: tools_k4_wide_variants.py, prefetch_lane.)
    for (int l = 0; l < num_lanes; ++l) {
      const uint32_t* in = lanes.in[l];
      uint32_t* out = lanes.out[l];
      uint32_t v[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const long long i = tile_start + (long long)r * kThreads + tid;
        v[r] = (full || i < n) ? __ldg(in + i) : 0u;
      }
#pragma unroll
      for (int r = 0; r < kItems; ++r) stage[inverse[r * kThreads + tid]] = v[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        if (dst[r] != kDropped) out[dst[r]] = stage[r * kThreads + tid];
      }
      __syncthreads();  // the stage is read before the next lane
    }
  }
  if (kSlots) return;

  // the pads: this block's share [lo, hi) of the pad slots, which run region
  // by region; region b ends at (b + 1) * capacity (dense: at n)
  const int regions = dense ? 1 : num_groups / group_size;
  const unsigned long long total = pad_before[regions];
  const unsigned long long share = (total + gridDim.x - 1) / gridDim.x;
  const unsigned long long lo = (unsigned long long)blockIdx.x * share;
  const unsigned long long hi = lo + share < total ? lo + share : total;
  if (lo >= hi) return;
  // the last region whose pads start at or before lo
  int b = 0, top = regions - 1;
  while (b < top) {
    const int mid = (b + top + 1) >> 1;
    if (pad_before[mid] <= lo) b = mid; else top = mid - 1;
  }
  for (; b < regions; ++b) {
    const unsigned long long pb = pad_before[b];
    const unsigned long long pe = pad_before[b + 1];
    if (pb >= hi) break;
    if (pe <= lo) continue;
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

template <bool kSlots>
cudaError_t allow_sweep_smem() {
  // the largest table, once a thread and device, so no call lowers it
  static thread_local int done_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || done_device == device) return err;
  err = cudaFuncSetAttribute(sweep_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSweepBytes);
  if (err == cudaSuccess) done_device = device;
  return err;
}

long long round8(long long bytes) { return (bytes + 7) / 8 * 8; }

}  // namespace

extern "C" {

// The scratch of one call, in bytes (wide_scratch_layout in
// ops/kernels/partition.py): pad_before (8 * (regions + 1)), starts (4 *
// (num_groups + 1)), totals (4 * num_groups), chunk words (4 * chunks *
// num_groups), tile rows (2 * tiles * num_groups), each rounded up to 8 bytes,
// in that order; tiles = ceil(n / 8192), chunks = max(1, ceil(tiles / 4)),
// regions = 1 in dense mode, else num_groups / group_size.
long long rj_partition_wide_scratch_bytes(long long n, int num_groups, int group_size,
                                          long long capacity) {
  const long long tiles = (n + kTile - 1) / kTile;
  long long chunks = (tiles + kChunk - 1) / kChunk;
  if (chunks < 1) chunks = 1;
  const long long regions = capacity < 0 ? 1 : num_groups / group_size;
  return round8(8 * (regions + 1)) + round8(4 * ((long long)num_groups + 1)) +
         round8(4 * (long long)num_groups) + round8(4 * chunks * num_groups) +
         round8(2 * tiles * num_groups);
}

// One grouping call for 1 <= num_groups <= 8192 (the wrapper takes it past
// 256).  ids: uint32 [n]; capacity < 0 for dense mode, else the block size,
// with (num_groups / group_size) * capacity <= 0xFFFFFFFF.  slots != null:
// writes uint32 slots[n] and moves nothing.  slots == null: moves num_lanes
// (<= 4) lanes (host arrays of device pointers; inputs of n, outputs of the
// layout's size) and writes every other output slot with fills[lane].
// scratch: rj_partition_wide_scratch_bytes(...) bytes, written before it is
// read (no memset); the totals (hist) land at its third part.  Four launches
// on `stream`; returns the first cudaError_t.
int rj_partition_wide(const void* ids, long long n, int num_groups, int group_size,
                      long long capacity, void* slots, int num_lanes, const void* const* lanes_in,
                      void* const* lanes_out, const unsigned* fills, void* scratch,
                      long long scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > 0xFFFFFFFFll || num_groups < 1 || num_groups > kMaxGroups ||
      group_size < 1 || num_groups % group_size != 0 || num_lanes < 0 ||
      num_lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  if (capacity >= 0 &&
      (capacity == 0 || (long long)(num_groups / group_size) * capacity > 0xFFFFFFFFll))
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes != rj_partition_wide_scratch_bytes(n, num_groups, group_size, capacity))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  long long chunks = (tiles + kChunk - 1) / kChunk;
  if (chunks < 1) chunks = 1;
  const bool dense = capacity < 0;
  const long long regions = dense ? 1 : num_groups / group_size;
  unsigned char* p = static_cast<unsigned char*>(scratch);
  auto* pad_before = reinterpret_cast<unsigned long long*>(p);
  p += round8(8 * (regions + 1));
  auto* starts = reinterpret_cast<uint32_t*>(p);
  p += round8(4 * ((long long)num_groups + 1));
  auto* totals = reinterpret_cast<uint32_t*>(p);
  p += round8(4 * (long long)num_groups);
  auto* chunk_words = reinterpret_cast<uint32_t*>(p);
  p += round8(4 * chunks * num_groups);
  auto* rows = reinterpret_cast<uint16_t*>(p);
  const uint32_t* k = static_cast<const uint32_t*>(ids);

  count_kernel<<<(unsigned)chunks, kThreads, 0, st>>>(k, n, num_groups, tiles, rows, chunk_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_kernel<<<(unsigned)((num_groups + 31) / 32), 32 * kCarryLanes, 0, st>>>(
      chunk_words, chunks, num_groups, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool moving = slots == nullptr && num_lanes > 0;
  starts_kernel<<<1, kScanThreads, 0, st>>>(totals, num_groups, group_size, capacity, n, moving,
                                             starts, pad_before);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kStageBytes + kUnionBytes + 4 * ((size_t)num_groups + 1);
  if (slots != nullptr) {
    err = allow_sweep_smem<true>();
    if (err != cudaSuccess) return (int)err;
    sweep_kernel<true><<<(unsigned)(tiles > 0 ? tiles : 1), kThreads, smem, st>>>(
        k, n, num_groups, group_size, capacity, tiles, static_cast<uint32_t*>(slots), Lanes{}, 0,
        rows, chunk_words, starts, pad_before);
    return (int)cudaGetLastError();
  }
  Lanes lanes{};
  for (int l = 0; l < num_lanes; ++l) {
    lanes.in[l] = static_cast<const uint32_t*>(lanes_in[l]);
    lanes.out[l] = static_cast<uint32_t*>(lanes_out[l]);
    lanes.fill[l] = fills[l];
  }
  // enough blocks that none writes much more than kPadSlots pad slots
  const long long out_size = dense ? n : regions * capacity;
  long long blocks = tiles;
  if (num_lanes > 0 && (out_size + kPadSlots - 1) / kPadSlots > blocks)
    blocks = (out_size + kPadSlots - 1) / kPadSlots;
  if (blocks < 1) blocks = 1;
  err = allow_sweep_smem<false>();
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<false><<<(unsigned)blocks, kThreads, smem, st>>>(
      k, n, num_groups, group_size, capacity, tiles, nullptr, lanes, num_lanes, rows, chunk_words,
      starts, pad_before);
  return (int)cudaGetLastError();
}

}  // extern "C"
