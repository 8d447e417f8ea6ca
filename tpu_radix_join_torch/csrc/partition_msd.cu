// K4 past the wide kernel's 8192 groups: a stable grouping of tuples by an id
// of any width, as a coarse pass and segmented passes (MSD digits).
//
// Replaces tpu_radix_join/ops/pallas/partition.py::partition_slots_pallas
// (_kernel) where num_groups > 8192 (partition_wide.cu holds 257..8192), the
// fanouts the TPU kernel's SMEM cursors never held (the JAX package falls
// back to its sort arm there).
// The contract is K4's (partition.cu): for uint32 ids [n], n < 2**32, invalid
// ids (>= num_groups) are counted nowhere and dropped; dense mode gives a
// stable grouping permutation; blocked mode gives group_size consecutive
// groups a block of `capacity` slots, input order within a group, and a tuple
// whose unclipped position in its block is >= capacity gets 0xFFFFFFFF, so
// the clip eats a block's highest groups first; the totals are exact.  A call
// writes slots[n] (slots mode) or moves up to four uint32 lanes and writes
// every other output slot with the lane's fill (dense [valid total, n);
// blocked each block's tail [min(count, capacity), capacity)).
//
// Bound on the H100: bytes.  A grouping must read the ids and each moved lane
// once and write each output once: 4 n + 4 n L + 4 size L bytes.
//
// Design.  The onesweep of partition.cu gives thread `tid` group `tid` and a
// look-back word a tile and group: it holds 256 groups.  The wide kernel's
// shared tables hold 8192, and its write runs shrink with the groups (a
// group's run in a tile of 8192 ids is 2 ids at 4097 groups).  Past them a
// group id of B = bit_length(num_groups - 1) bits is split into L =
// ceil(B / 8) digits of at most 8 bits, most significant first (the bits
// spread evenly, the first pass taking the fewest), and each pass is that
// onesweep over one digit (its code copied here, not shared, so that the
// narrow K4's instance stays as it is), so every pass groups by at most 256
// values and a tile of 4096 ids writes runs of 16 ids or more a value:
//   0. the exact totals come from K1 at num_groups bins (the wrapper's
//      histogram() call, before this entry), and scan_kernel (one block)
//      turns them into the group starts, starts[g] = the valid ids of the
//      groups below g, with starts[num_groups] the valid total, and, for each
//      pass after the first, its tile map: the exclusive scan over segments
//      of ceil(segment length / kTile) tiles;
//   1. the coarse pass groups the tuples stably by their top digit; an
//      invalid id is dropped here (its slot written 0xFFFFFFFF in slots
//      mode), so every later pass holds the valid total.  Its output is the
//      id and the moved lanes (slots mode: the id and its input index),
//      each at starts[first group of its digit] + its rank;
//   2. each later pass is one onesweep over every segment at once, a segment
//      being the tuples of one value of the digits above (contiguous, in
//      order, after the pass before).  A tile never straddles two segments:
//      tile t of the pass finds its segment in the tile map (a 256-ary
//      search over the map, one parallel load a round), and its range is
//      the segment's start plus (t - the segment's first tile) * kTile.  The
//      grid is the upper bound ceil(n / kTile) + segments, surplus blocks
//      exit, so the host reads nothing back.  A segment's first tile
//      publishes its counts as inclusive at once, so each segment runs its
//      own look-back chain, which never reads a tile of another segment;
//   3. the last pass's digit is the group's lowest: a tuple's place is the
//      group's start plus its rank within the group (its block's start
//      subtracted, and the capacity applied, in blocked mode), written as the
//      final dense or blocked layout; every block then writes its share of
//      the pad slots, region by region.  Slots mode writes slots[index].
// Every pass is stable and a pass keeps the order of the one before within a
// segment, so the whole is stable by the id.  The id rides as one more lane
// through every pass but the last, so five lanes ride a pass at most (the id
// and the caller's four); lanes go through the shared stage one at a time, so
// their number costs no shared memory.  Bytes, two moved lanes and two
// passes: K1 reads the ids (4 n), the coarse pass reads the id and the lanes
// and writes them (24 n), the last pass reads them and writes the lanes (12 n
// + 8 size): 10 words a tuple against the bound's 5.
//
// Positions are below n < 2**32, so starts are uint32 and bases 64-bit until
// the clip.  Look-back words are 64 bits, a flag over a 32-bit count,
// stored and loaded relaxed (lookback.cuh).  The look-back gives each digit
// 256 / digits lanes (at most 32), each reading kLookBack words a round.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it): the moving passes
// 126-128 registers and no spills at two blocks an SM (44,068 bytes of
// shared memory); at four blocks an SM (64 registers) they spilled 232-272
// bytes and took 15% longer (tools_k1_k4_profile.py's min_blocks_4); the
// last slots pass 64 registers, 27,684 bytes; the scan 47 registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "lookback.cuh"

namespace {

constexpr int kDigitBits = 8;  // most bits a pass groups by
constexpr int kDigits = 1 << kDigitBits;
constexpr int kThreads = 256;  // thread `tid` owns digit `tid` in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;     // ids a thread holds
constexpr int kMinBlocks = 2;  // blocks an SM keeps: 128 registers a thread, no spills
constexpr int kLookBack = 8;   // look-back words a thread reads at once
constexpr int kWarpIds = 32 * kItems;
constexpr int kTile = kThreads * kItems;  // MSD_TILE_IDS in ops/kernels/partition.py
constexpr int kSlotBits = 13;  // a local slot < kTile
constexpr int kMaxPasses = 4;  // ceil(31 / kDigitBits): every num_groups < 2**31
constexpr int kMaxLanes = 5;   // the id and four moved lanes
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr uint32_t kDropped = 0xFFFFFFFFu;
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
constexpr uint32_t kAggregate = 1u;  // look-back status, high word
constexpr uint32_t kInclusive = 2u;
static_assert(kTile <= (1 << kSlotBits), "a local slot fits kSlotBits");
static_assert(kDigits == kThreads, "one thread a digit");

struct Lanes {
  const uint32_t* in[kMaxLanes];  // null: the input position (the coarse pass's index lane)
  uint32_t* out[kMaxLanes];
  uint32_t fill[kMaxLanes];
};

// One pass: it groups by digit (id >> shift) & (2**bits - 1) within each
// segment, a segment being one value of id >> (shift + bits) (the first pass:
// one segment, the whole input).
struct Pass {
  const uint32_t* ids;
  int shift;
  int bits;
  int digits;                    // digit values (the first pass: the top digit's range)
  long long segments;            // 0 for the first pass
  const uint32_t* tile_map;      // [segments + 1]: each segment's first tile
  unsigned long long* lookback;  // tiles x digits words, zeroed
  uint32_t* counter;             // the tile counter, zeroed
  long long tiles;               // the first pass's tiles (ceil(n / kTile))
};

struct Plan {
  int passes;
  int shift[kMaxPasses];
  int bits[kMaxPasses];
};

struct Maps {
  uint32_t* map[kMaxPasses];  // each later pass's tile map
};

// The digits of a group id of bit_length(num_groups - 1) bits: ceil(B / 8)
// passes, the bits spread evenly, the earlier passes taking the fewer.
Plan plan_for(int num_groups) {
  int b = 0;
  while (b < 31 && (1ll << b) < (long long)num_groups) ++b;  // bit_length(num_groups - 1)
  Plan p{};
  p.passes = (b + kDigitBits - 1) / kDigitBits;
  if (p.passes < 2) p.passes = 2;
  int below = b;
  for (int l = 0; l < p.passes; ++l) {
    const int left = p.passes - l;
    p.bits[l] = below / left;  // floor: the earlier passes take the fewer bits
    below -= p.bits[l];
    p.shift[l] = below;
  }
  return p;
}

__device__ __forceinline__ void publish(unsigned long long* p, uint32_t flag, uint32_t count) {
  rj::store_relaxed(p, ((unsigned long long)flag << 32) | (unsigned long long)count);
}

// Adds one to hist[d] for every lane whose d is a digit (< kDigits); a warp
// whose counted lanes share one digit adds once.  Every lane calls it.
__device__ __forceinline__ void count_digit(int d, uint32_t* hist) {
  const int lane = threadIdx.x & 31;
  const bool counted = d < kDigits;
  const unsigned lanes = __ballot_sync(0xffffffffu, counted);
  if (lanes == 0u) return;
  const int first = __ffs(lanes) - 1;
  const int d0 = __shfl_sync(0xffffffffu, d, first);
  if (__all_sync(0xffffffffu, !counted || d == d0)) {
    if (lane == first) atomicAdd(hist + d0, (uint32_t)__popc(lanes));
  } else if (counted) {
    atomicAdd(hist + d, 1u);
  }
}

// starts[g] for g <= num_groups (the exclusive scan of the totals, the valid
// total last), then each later pass's tile map: map[q] = the tiles of the
// segments before q, map[segments] = the pass's tiles.  One block; chunks of
// kScanThreads x kScanItems words in order with a carry, each loaded and
// stored coalesced through shared memory and scanned thread-contiguous.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const uint32_t* __restrict__ totals, long long num_groups, uint32_t* starts,
            Plan plan, Maps maps) {
  constexpr long long kChunk = (long long)kScanThreads * kScanItems;
  __shared__ uint32_t buf[kChunk];
  __shared__ uint32_t scratch[kScanThreads / 32];
  const int tid = threadIdx.x;
  // the exclusive scan of f(0..count) after `carry`, written to out[0..count)
  auto scan = [&](long long count, uint32_t carry, uint32_t* out, auto f) -> uint32_t {
    for (long long c = 0; c < count; c += kChunk) {
#pragma unroll
      for (int k = 0; k < kScanItems; ++k) {
        const long long i = c + (long long)k * kScanThreads + tid;
        buf[k * kScanThreads + tid] = i < count ? f(i) : 0u;
      }
      __syncthreads();
      uint32_t v[kScanItems];
      uint32_t sum = 0u;
#pragma unroll
      for (int k = 0; k < kScanItems; ++k) {
        v[k] = buf[tid * kScanItems + k];
        sum += v[k];
      }
      uint32_t total;
      uint32_t run = carry + rj::block_exclusive_scan<kScanThreads>(sum, 0u, rj::SumOp(),
                                                                   scratch, &total);
#pragma unroll
      for (int k = 0; k < kScanItems; ++k) {
        buf[tid * kScanItems + k] = run;
        run += v[k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kScanItems; ++k) {
        const long long i = c + (long long)k * kScanThreads + tid;
        if (i < count) out[i] = buf[k * kScanThreads + tid];
      }
      carry += total;
      __syncthreads();  // buf is read before the next chunk
    }
    return carry;
  };
  const uint32_t valid = scan(num_groups, 0u, starts,
                              [&](long long g) { return __ldg(totals + g); });
  if (tid == 0) starts[num_groups] = valid;
  __syncthreads();  // the block's writes of starts are visible to it
  for (int l = 1; l < plan.passes; ++l) {
    const int above = plan.shift[l] + plan.bits[l];  // a segment: one id >> above
    const long long segments = ((num_groups - 1) >> above) + 1;
    const uint32_t tiles = scan(segments, 0u, maps.map[l], [&](long long q) {
      const long long g1 = (q + 1) << above;
      const uint32_t len = starts[g1 < num_groups ? g1 : num_groups] - starts[q << above];
      return (len + kTile - 1) / kTile;
    });
    if (tid == 0) maps.map[l][segments] = tiles;
  }
}

// The slot of a tuple of group g at unclipped position pos within its layout
// block (dense: within the whole output), or kDropped past the capacity.
__device__ __forceinline__ uint32_t slot_of(long long pos, long long g, long long group_size,
                                            long long capacity) {
  if (capacity < 0) return (uint32_t)pos;
  if (pos >= capacity) return kDropped;
  return (uint32_t)((g / group_size) * capacity + pos);
}

// One pass.  kLast: the digit is the group's lowest and the pass writes the
// layout (slots, or the lanes and the pads); else it writes the id and the
// lanes at their positions for the next pass.  kSlots: slots mode (the lanes
// are the id and the index before the last pass, the index in it).
template <bool kLast, bool kSlots>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pass_kernel(Pass pv, long long n, long long num_groups, long long group_size, long long capacity,
            const uint32_t* __restrict__ starts, uint32_t* __restrict__ slots, Lanes lanes,
            int num_lanes, long long out_size) {
  __shared__ uint32_t stage[kTile];  // the tile in (digit, rank) order
  __shared__ uint32_t warp_base[kWarps][kDigits];
  __shared__ uint32_t lanes_of[2][kWarps][kDigits];  // per item: lanes holding a digit
  __shared__ long long rel_base[kDigits];  // position - local slot, per digit
  __shared__ uint32_t before_digit[kDigits];  // ids of the digit in the segment's tiles before
  __shared__ uint32_t scratch[kWarps];
  __shared__ uint32_t tile_shared;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;
  const bool first_pass = pv.segments == 0;
  const int digits = pv.digits;
  int sub = 32;  // look-back lanes a digit: 256 / digits rounded, at most 32
  while (sub > 1 && sub * digits > kThreads) sub >>= 1;

  if (tid == 0) tile_shared = atomicAdd(pv.counter, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    warp_base[w][tid] = 0u;
    lanes_of[0][w][tid] = 0u;
    lanes_of[1][w][tid] = 0u;
  }
  __syncthreads();
  const long long tile = tile_shared;
  // the tile's segment q, its first tile and the tile's range [lo, hi)
  long long q = 0, first_tile = 0, lo = 0, hi = 0;
  bool live;  // block-uniform
  if (first_pass) {
    live = tile < pv.tiles;
    lo = tile * kTile;
    hi = lo + kTile < n ? lo + kTile : n;
  } else {
    live = tile < (long long)__ldg(pv.tile_map + pv.segments);
    if (live) {
      // the last segment whose first tile is <= tile, in [a, b): a 256-ary
      // search, one parallel load a round (map[a] <= tile always holds)
      long long a = 0, b = pv.segments;
      while (b - a > 1) {
        const long long step = (b - a + kThreads - 1) / kThreads;
        const long long c = a + (long long)tid * step;
        const int below =
            __syncthreads_count(c < b && (long long)__ldg(pv.tile_map + c) <= tile);
        a += (long long)(below - 1) * step;
        b = a + step < b ? a + step : b;
      }
      q = a;
      first_tile = __ldg(pv.tile_map + q);
      const int above = pv.shift + pv.bits;
      const long long g1 = (q + 1) << above;
      const long long seg_hi = __ldg(starts + (g1 < num_groups ? g1 : num_groups));
      lo = (long long)__ldg(starts + (q << above)) + (tile - first_tile) * kTile;
      hi = lo + kTile < seg_hi ? lo + kTile : seg_hi;
    }
  }

  if (live) {
    // each digit's base: the first position of its prefix's groups (the
    // next pass's input), or in the last pass the group's start, its
    // block's start subtracted in blocked mode
    const bool real = tid < digits;
    long long base = 0;
    if (real) {
      const long long r = (q << pv.bits) | tid;
      long long g = r << pv.shift;
      if (g > num_groups) g = num_groups;
      base = __ldg(starts + g);
      if (kLast && capacity >= 0) base -= __ldg(starts + (g / group_size) * group_size);
    }
    const long long warp_start = lo + (long long)warp * kWarpIds;
    const bool full = lo + kTile <= hi;  // every row in range
    const uint32_t mask = (1u << pv.bits) - 1u;

    uint32_t dig[kItems];  // digit, kDigits for an invalid id or a row past the tile
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = warp_start + 32 * j + lane;
      dig[j] = kDigits;
      if (full || i < hi) {
        const uint32_t id = __ldg(pv.ids + i);
        if (!first_pass) {
          dig[j] = (id >> pv.shift) & mask;
        } else if ((long long)id < num_groups) {
          dig[j] = id >> pv.shift;
        } else if (kSlots) {
          slots[i] = kDropped;  // an invalid id: dropped here, in no later pass
        }
      }
    }
    uint32_t* counter = warp_base[warp];
#pragma unroll
    for (int j = 0; j < kItems; ++j) count_digit((int)dig[j], counter);
    __syncthreads();

    // each digit's count in the tile, published at once (inclusive in the
    // segment's first tile); the warps' exclusive prefix and the digit's
    // start in the tile
    uint32_t count = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_base[w][tid];
      warp_base[w][tid] = count;
      count += c;
    }
    unsigned long long* mine = pv.lookback + tile * digits + tid;
    if (real) publish(mine, tile == first_tile ? kInclusive : kAggregate, count);
    uint32_t tile_n;
    const uint32_t local_start = rj::block_exclusive_scan<kThreads>(
        count, 0u, rj::SumOp(), scratch, &tile_n);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_base[w][tid] += local_start;
    __syncthreads();

    // rank item by item, as partition.cu: a warp whose ranked lanes share
    // one digit knows its peers from the ballot; otherwise the lanes of one
    // digit gather in a shared word by atomicOr.  info = digit << kSlotBits
    // | local slot, or kInvalid.
    uint32_t info[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int d = (int)dig[j];
      const bool valid = d < kDigits;
      const unsigned valid_lanes = __ballot_sync(0xffffffffu, valid);
      unsigned peers = 0u;
      if (valid_lanes != 0u) {
        const int d0 = __shfl_sync(0xffffffffu, d, __ffs(valid_lanes) - 1);
        if (__all_sync(0xffffffffu, !valid || d == d0)) {
          peers = valid ? valid_lanes : 0u;
        } else {
          uint32_t* word = &lanes_of[j & 1][warp][valid ? d : 0];
          if (valid) atomicOr(word, 1u << lane);
          __syncwarp();
          peers = valid ? *word : 0u;
          __syncwarp();
          if (valid && lane == __ffs(peers) - 1) *word = 0u;
        }
      }
      __syncwarp();
      const int leader = __ffs(peers) - 1;
      uint32_t next = 0u;
      if (valid && lane == leader) {
        next = counter[d];
        counter[d] = next + (uint32_t)__popc(peers);
      }
      const uint32_t slot = __shfl_sync(0xffffffffu, next, leader < 0 ? 0 : leader) +
                            (uint32_t)__popc(peers & lanemask_lt);
      if (valid) {
        if (!(kLast && kSlots)) stage[slot] = (uint32_t)d;
        info[j] = ((uint32_t)d << kSlotBits) | slot;
      } else {
        info[j] = kInvalid;
      }
    }

    // decoupled look-back within the segment: `sub` lanes of one warp share
    // a digit, each reading kLookBack words a round back from tile - 1, and
    // never a tile before the segment's first.  The loops are warp-uniform.
    {
      const int ld = tid / sub;
      const int sl = tid % sub;
      const unsigned sub_mask =
          sub == 32 ? 0xffffffffu : ((1u << sub) - 1u) << (lane & ~(sub - 1));
      bool done = !(ld < digits && tile > first_tile);
      uint32_t acc = 0u;
      long long t = tile - 1 - (long long)sl * kLookBack;
      while (__any_sync(0xffffffffu, !done)) {
        unsigned long long w[kLookBack];
        bool ready;
        do {
          ready = true;
#pragma unroll
          for (int k = 0; k < kLookBack; ++k) {
            const bool read = !done && t - k >= first_tile;
            w[k] = read ? rj::load_relaxed(pv.lookback + (t - k) * digits + ld) : 0ull;
            if (read && (w[k] >> 32) == 0ull) ready = false;
          }
        } while (!__all_sync(0xffffffffu, ready));
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
      if (ld < digits && sl == 0) before_digit[ld] = acc;
    }
    __syncthreads();
    const uint32_t before_tile = real ? before_digit[tid] : 0u;
    if (real && tile > first_tile) publish(mine, kInclusive, before_tile + count);
    rel_base[tid] = base + (long long)before_tile - (long long)local_start;
    __syncthreads();

    constexpr uint32_t kSlotMask = (1u << kSlotBits) - 1u;
    const long long group_hi = q << pv.bits;  // the last pass: group = group_hi | digit
    if (kLast && kSlots) {
      // slots[index] for every id; the index lane is lanes.in[0]
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (info[j] == kInvalid) continue;
        const long long i = warp_start + 32 * j + lane;
        const int d = (int)(info[j] >> kSlotBits);
        slots[__ldg(lanes.in[0] + i)] = slot_of(rel_base[d] + (long long)(info[j] & kSlotMask),
                                                group_hi | d, group_size, capacity);
      }
    } else {
      // the destination of every staged id: consecutive threads,
      // consecutive places of each digit's run
      uint32_t dst[kItems];
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        const int i = r * kThreads + tid;
        dst[r] = kDropped;
        if (i < (int)tile_n) {
          const int d = (int)stage[i];
          dst[r] = kLast ? slot_of(rel_base[d] + i, group_hi | d, group_size, capacity)
                         : (uint32_t)(rel_base[d] + i);
        }
      }
      // every lane through the stage: a warp-striped load (or the input
      // position, for the coarse pass's index lane), a store at the id's
      // local slot, a write in (digit, rank) order
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) {
        if (l >= num_lanes) break;
        const uint32_t* in = lanes.in[l];
        uint32_t* out = lanes.out[l];
        uint32_t v[kItems];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const long long i = warp_start + 32 * j + lane;
          v[j] = info[j] == kInvalid ? 0u : in != nullptr ? __ldg(in + i) : (uint32_t)i;
        }
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
  if (!kLast || kSlots || num_lanes == 0) return;

  // the pads: this block's share [lo, hi) of the layout's slots; in each
  // region (a layout block, or the whole output in dense mode) the slots
  // from its count on are pads
  const long long region = capacity < 0 ? n : capacity;
  if (region == 0) return;
  const long long share = (out_size + gridDim.x - 1) / gridDim.x;
  const long long from = (long long)blockIdx.x * share;
  const long long to = from + share < out_size ? from + share : out_size;
  for (long long b = from / region; b * region < to; ++b) {  // block-uniform
    long long count;
    if (capacity < 0) {
      count = __ldg(starts + num_groups);
    } else {
      const long long g1 = (b + 1) * group_size;
      count = (long long)__ldg(starts + (g1 < num_groups ? g1 : num_groups)) -
              (long long)__ldg(starts + b * group_size);
    }
    long long x0 = b * region + (count < region ? count : region);
    long long x1 = (b + 1) * region;
    if (x0 < from) x0 = from;
    if (x1 > to) x1 = to;
    for (long long x = x0 + tid; x < x1; x += kThreads) {
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) {
        if (l >= num_lanes) break;
        lanes.out[l][x] = lanes.fill[l];
      }
    }
  }
}

struct Layout {
  Plan plan;
  long long tiles[kMaxPasses];        // each pass's grid (the later passes: the upper bound)
  long long lookback_off[kMaxPasses];  // 8-byte words
  long long zeroed_bytes;              // the look-back tables and the counters
  long long starts_off;                // bytes
  long long map_off[kMaxPasses];       // bytes
  long long lanes_off[2];              // bytes: the two ping-pong sets of lanes
  long long bytes;
};

long long round8(long long b) { return (b + 7) / 8 * 8; }

// The scratch of a call: the look-back tables and the tile counters (zeroed
// by one memset), the starts, the tile maps, and the lanes between passes
// (one set of `riding` lanes of n words for two passes, two sets past them).
Layout layout_for(long long n, int num_groups, int riding) {
  Layout lay{};
  lay.plan = plan_for(num_groups);
  const Plan& p = lay.plan;
  const long long tiles0 = (n + kTile - 1) / kTile;
  long long words = 0;
  for (int l = 0; l < p.passes; ++l) {
    const long long above = p.shift[l] + p.bits[l];
    const long long segments = l == 0 ? 0 : (((long long)num_groups - 1) >> above) + 1;
    const long long digits =
        l == 0 ? (((long long)num_groups - 1) >> p.shift[0]) + 1 : (1ll << p.bits[l]);
    lay.tiles[l] = tiles0 + segments;
    lay.lookback_off[l] = words;
    words += lay.tiles[l] * digits;
  }
  long long bytes = 8 * words;
  bytes += round8(4 * kMaxPasses);  // the tile counters
  lay.zeroed_bytes = bytes;
  lay.starts_off = bytes;
  bytes += round8(4 * ((long long)num_groups + 1));
  for (int l = 1; l < p.passes; ++l) {
    const long long above = p.shift[l] + p.bits[l];
    lay.map_off[l] = bytes;
    bytes += round8(4 * ((((long long)num_groups - 1) >> above) + 2));
  }
  for (int s = 0; s < (p.passes > 2 ? 2 : 1); ++s) {
    lay.lanes_off[s] = bytes;
    bytes += round8(4 * n * riding);
  }
  lay.bytes = bytes;
  return lay;
}

// The lanes that ride between passes: the id, then the moved lanes (slots
// mode: the input index).
int riding_lanes(bool slots, int num_lanes) { return 1 + (slots ? 1 : num_lanes); }

}  // namespace

extern "C" {

// Bytes of the scratch a call of rj_partition_msd takes.
long long rj_partition_msd_scratch_bytes(long long n, int num_groups, int slots_mode,
                                         int num_lanes) {
  if (n < 0 || num_groups < 2) return -1;
  return layout_for(n, num_groups, riding_lanes(slots_mode != 0, num_lanes)).bytes;
}

// One grouping call past the wide kernel's groups.  ids: uint32 [n]; totals:
// uint32 [num_groups], the exact counts of the valid ids (K1's); capacity < 0
// for dense mode, else the block size with (num_groups / group_size) *
// capacity <= 0xFFFFFFFF.  slots != null: writes uint32 slots[n] and moves
// nothing; else moves num_lanes (<= 4) lanes (host arrays of device
// pointers: inputs of n, outputs of out_size) and writes every other output
// slot with fills[lane].  scratch: rj_partition_msd_scratch_bytes(n,
// num_groups, slots != null, num_lanes) bytes.  A memset, the scan kernel and
// one launch a pass on `stream`; returns a cudaError_t.
int rj_partition_msd(const void* ids, long long n, int num_groups, int group_size,
                     long long capacity, const void* totals, void* slots, int num_lanes,
                     const void* const* lanes_in, void* const* lanes_out, const unsigned* fills,
                     void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > 0xFFFFFFFFll || num_groups < 2 || group_size < 1 ||
      num_groups % group_size != 0 || num_lanes < 0 || num_lanes > kMaxLanes - 1)
    return (int)cudaErrorInvalidValue;
  if (capacity >= 0 &&
      (capacity == 0 || (long long)(num_groups / group_size) * capacity > 0xFFFFFFFFll))
    return (int)cudaErrorInvalidValue;
  const bool slots_mode = slots != nullptr;
  const int riding = riding_lanes(slots_mode, num_lanes);
  const Layout lay = layout_for(n, num_groups, riding);
  if (scratch_bytes != lay.bytes) return (int)cudaErrorInvalidValue;
  const long long out_size =
      capacity < 0 ? n : (long long)(num_groups / group_size) * capacity;
  if (!slots_mode && (num_lanes == 0 || out_size == 0)) return (int)cudaGetLastError();
  if (slots_mode && n == 0) return (int)cudaGetLastError();
  char* base = static_cast<char*>(scratch);
  cudaError_t err = cudaMemsetAsync(base, 0, (size_t)lay.zeroed_bytes, st);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* lookback = reinterpret_cast<unsigned long long*>(base);
  uint32_t* counters = reinterpret_cast<uint32_t*>(base + lay.zeroed_bytes) - kMaxPasses;
  uint32_t* starts = reinterpret_cast<uint32_t*>(base + lay.starts_off);
  const Plan& p = lay.plan;
  Maps maps{};
  for (int l = 1; l < p.passes; ++l)
    maps.map[l] = reinterpret_cast<uint32_t*>(base + lay.map_off[l]);
  scan_kernel<<<1, kScanThreads, 0, st>>>(static_cast<const uint32_t*>(totals), num_groups,
                                           starts, p, maps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  uint32_t* sets[2] = {reinterpret_cast<uint32_t*>(base + lay.lanes_off[0]),
                       reinterpret_cast<uint32_t*>(base + lay.lanes_off[p.passes > 2 ? 1 : 0])};
  uint32_t* slot_out = static_cast<uint32_t*>(slots);
  // pass 0 reads the caller's ids and lanes (slots mode: the index is the
  // input position); pass l > 0 reads the set pass l - 1 wrote
  Lanes in{};
  in.in[0] = static_cast<const uint32_t*>(ids);
  for (int j = 0; j < num_lanes && !slots_mode; ++j)
    in.in[1 + j] = static_cast<const uint32_t*>(lanes_in[j]);
  for (int l = 0; l < p.passes; ++l) {
    const bool last = l == p.passes - 1;
    Pass pv{};
    pv.ids = in.in[0];
    pv.shift = p.shift[l];
    pv.bits = p.bits[l];
    pv.digits = l == 0 ? ((num_groups - 1) >> p.shift[0]) + 1 : 1 << p.bits[l];
    pv.segments = l == 0 ? 0 : (((long long)num_groups - 1) >> (p.shift[l] + p.bits[l])) + 1;
    pv.tile_map = l == 0 ? nullptr : maps.map[l];
    pv.lookback = lookback + lay.lookback_off[l];
    pv.counter = counters + l;
    pv.tiles = lay.tiles[l];
    const unsigned grid = (unsigned)lay.tiles[l];
    if (!last) {
      if (grid == 0) continue;  // no ids: the last pass still writes the pads
      Lanes lv = in;
      uint32_t* set = sets[l & 1];
      for (int j = 0; j < riding; ++j) lv.out[j] = set + (long long)j * n;
      if (slots_mode) {
        pass_kernel<false, true><<<grid, kThreads, 0, st>>>(pv, n, num_groups, group_size,
                                                            capacity, starts, slot_out, lv,
                                                            riding, out_size);
      } else {
        pass_kernel<false, false><<<grid, kThreads, 0, st>>>(pv, n, num_groups, group_size,
                                                             capacity, starts, nullptr, lv,
                                                             riding, out_size);
      }
      for (int j = 0; j < riding; ++j) in.in[j] = set + (long long)j * n;
    } else if (slots_mode) {
      Lanes lv{};
      lv.in[0] = in.in[1];  // the index
      pass_kernel<true, true><<<grid, kThreads, 0, st>>>(pv, n, num_groups, group_size, capacity,
                                                         starts, slot_out, lv, 1, out_size);
    } else {
      Lanes lv{};
      for (int j = 0; j < num_lanes; ++j) {
        lv.in[j] = in.in[1 + j];
        lv.out[j] = static_cast<uint32_t*>(lanes_out[j]);
        lv.fill[j] = fills[j];
      }
      pass_kernel<true, false><<<grid, kThreads, 0, st>>>(pv, n, num_groups, group_size, capacity,
                                                          starts, nullptr, lv, num_lanes,
                                                          out_size);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
