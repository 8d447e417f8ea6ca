// K2: stable 8-bit LSD radix sort over uint32 lanes, onesweep design.
//
// Replaces tpu_radix_join/ops/pallas/radix_sort.py::radix_pass_slots_pallas
// (:162, its tile body _digit_kernel :72), driven there by radix_sort_pallas
// (:209).  Contract of one pass: key i goes to slot digit_base[d] + (keys of
// digit d before i), d = (key >> shift) & 0xFF -- a dense permutation of
// [0, n), digit order across groups, input order within one.  A pass either
// moves up to four uint32 lanes to those slots itself (one of them the key
// lane) or writes the slots (radix_pass_slots).  Rows past n take no part,
// like the TPU kernel's pad rows.
//
// Bound on the H100: bytes.  A pass must read each lane once and write it
// once, 8 n bytes a lane at 3.35 TB/s; a sort is passes x lanes x 8 n.
//
// Design (after Adinets & Merrill, "Onesweep", 2022).  The TPU pass was
// stable across tiles for free: its grid ran in order and carried the digit
// cursors in SMEM.  Here a sort is one histogram launch and one launch a
// digit pass:
//   1. histogram_kernel reads every key lane once and counts the digits of
//      every pass of the sort into a [passes, 256] table (a permutation does
//      not change a lane's digits).  One wave of blocks; a block counts into
//      shared memory, a warp whose keys share one digit with one atomic (so
//      one-bin inputs do not serialise 32 lanes on one word), and adds its
//      table into the global one with one atomic a bin.
//   2. onesweep_kernel takes the next tile of kTile keys from a global
//      counter, so tiles start in index order and the look-back never waits
//      on a tile that is not running.  It loads the key lane warp-striped
//      (lane l holds base + 32 j + l: a warp load is one 128-byte line,
//      kItems of them in flight), counts each warp's digits with shared
//      atomics and publishes the tile's per-digit counts at once, then ranks
//      item by item: the lanes of equal digit gather in a shared word by
//      atomicOr (what __match_any_sync gives, without its cost per distinct
//      digit) and the lowest advances the warp's counter, so slots follow
//      input order and the pass is stable.  One thread per digit resolves
//      the digit's offset by decoupled look-back over the tiles before it,
//      kLookBack words at a time.  The tile sits in shared memory in
//      (digit, rank) order and is written out with consecutive threads on
//      consecutive slots of each digit's run; every other lane follows (a
//      warp-striped load, a store at the key's local slot, a read in order).
//      The key lane is read once a pass, the other lanes once each.
// Look-back words are 64 bits: a status (pass epoch << 2 | flag) over a
// 32-bit count, so a count up to n < 2**32 cannot overflow, and one 8-byte
// store cannot tear.  The word carries its whole message, so it is stored
// and loaded relaxed, without a fence.  The epoch (pass number + 1 within
// the sort) lets one zeroed table serve every pass of a sort.  Scratch comes
// from the caller, zeroed once a sort; nothing here allocates or waits.
//
// ptxas (-Xptxas -v, sm_90a; tools_k2_variants.py prints it): the moving
// pass 80 registers, 42,020 bytes of shared memory (three blocks an SM);
// the slots pass 80 registers, 25,636 bytes; the histogram 57 registers,
// 16,500 bytes; no spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = kRadix;  // thread `tid` owns digit `tid` in the scans
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;     // keys a thread holds
constexpr int kMinBlocks = 3;  // blocks an SM keeps: at most 85 registers a thread
constexpr int kLookBack = 8;   // look-back words a thread reads at once
constexpr int kWarpKeys = 32 * kItems;
constexpr int kTile = kThreads * kItems;
constexpr int kSlotBits = 13;  // a local slot < kTile
constexpr int kMaxLanes = 4;
constexpr int kMaxPasses = 4 * kMaxLanes;
constexpr int kHistThreads = kRadix;  // one thread per bin at the flush
constexpr int kHistItems = 8;  // 16-byte loads a histogram thread takes a round
constexpr uint32_t kInvalid = 0xFFFFFFFFu;
static_assert(kTile <= (1 << kSlotBits), "a local slot fits kSlotBits");

// look-back status: (epoch << 2) | flag in the high word, count in the low
constexpr uint32_t kAggregate = 1u;
constexpr uint32_t kInclusive = 2u;

struct Lanes {
  const uint32_t* in[kMaxLanes];
  uint32_t* out[kMaxLanes];
};

// The key lanes of a sort and the passes each one takes: rows
// first_row[k] .. first_row[k + 1] - 1 of the table count lane k's digits at
// shift[row].
struct HistRows {
  const uint32_t* keys[kMaxLanes];
  int first_row[kMaxLanes + 1];
  int shift[kMaxPasses];
  int num_keys;
};

// A look-back word holds its whole message, so relaxed accesses suffice: a
// reader needs no other write of the publishing block.  One 8-byte store
// cannot tear.
__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned long long* p, uint32_t epoch, uint32_t flag,
                                        uint32_t count) {
  const unsigned long long w =
      ((unsigned long long)((epoch << 2) | flag) << 32) | (unsigned long long)count;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// Lane `i` of an array of kMaxLanes pointers, by constant indices only (a
// dynamic index into a kernel parameter would copy it to local memory).
template <typename T>
__device__ __forceinline__ T pick(const T (&p)[kMaxLanes], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

// Adds each valid key's digit at shifts sh[0 .. rows) to rows r0.. of the
// block's table.  A warp whose valid keys share one digit adds once:
// one-bin inputs (all-equal keys, pad runs) would otherwise serialise 32
// lanes on one shared word.  Other warps add a key at a time.
__device__ __forceinline__ void count_digits(uint32_t key, bool valid, const int (&sh)[4],
                                             int rows, int r0, uint32_t (*hist)[kRadix]) {
  const int lane = threadIdx.x & 31;
  const unsigned valid_lanes = __ballot_sync(0xffffffffu, valid);
  if (valid_lanes == 0u) return;
  const int first = __ffs(valid_lanes) - 1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r >= rows) break;
    const uint32_t d = (key >> sh[r]) & 0xFFu;
    const uint32_t d0 = __shfl_sync(0xffffffffu, d, first);
    if (__all_sync(0xffffffffu, !valid || d == d0)) {
      if (lane == first) atomicAdd(&hist[r0 + r][d0], (uint32_t)__popc(valid_lanes));
    } else if (valid) {
      atomicAdd(&hist[r0 + r][d], 1u);
    }
  }
}

__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(HistRows rows, long long n, uint32_t* __restrict__ table) {
  __shared__ uint32_t hist[kMaxPasses][kRadix];
  __shared__ const uint32_t* keys_of[kMaxLanes];
  __shared__ int first_row[kMaxLanes + 1];
  __shared__ int shift_of[kMaxPasses];
  const int tid = threadIdx.x;
  if (tid == 0) {  // the parameters by constant index, into shared memory
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) keys_of[k] = rows.keys[k];
#pragma unroll
    for (int k = 0; k <= kMaxLanes; ++k) first_row[k] = rows.first_row[k];
#pragma unroll
    for (int r = 0; r < kMaxPasses; ++r) shift_of[r] = rows.shift[r];
  }
  const int total = rows.first_row[kMaxLanes];  // lanes past num_keys add none
  for (int r = 0; r < total; ++r) hist[r][tid] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kHistThreads * kHistItems;
  for (int k = 0; k < rows.num_keys; ++k) {
    const uint32_t* keys = keys_of[k];
    const int r0 = first_row[k];
    const int nrows = first_row[k + 1] - r0;  // at most 4: a lane has 4 digits
    int sh[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) sh[r] = r < nrows ? shift_of[r0 + r] : 0;
    // 16-byte loads over the aligned body, 4-byte loads over the rest; the
    // loop bounds are uniform across the block, as the warp votes need
    const long long nvec = ((uintptr_t)keys & 15u) == 0 ? n / 4 : 0;
    const uint4* vec = reinterpret_cast<const uint4*>(keys);
    for (long long b = (long long)blockIdx.x * kHistThreads * kHistItems; b < nvec;
         b += stride) {
      uint4 q[kHistItems];
#pragma unroll
      for (int j = 0; j < kHistItems; ++j) {
        const long long v = b + (long long)j * kHistThreads + tid;
        q[j] = v < nvec ? __ldg(vec + v) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < kHistItems; ++j) {
        const bool valid = b + (long long)j * kHistThreads + tid < nvec;
        count_digits(q[j].x, valid, sh, nrows, r0, hist);
        count_digits(q[j].y, valid, sh, nrows, r0, hist);
        count_digits(q[j].z, valid, sh, nrows, r0, hist);
        count_digits(q[j].w, valid, sh, nrows, r0, hist);
      }
    }
    for (long long b = 4 * nvec + (long long)blockIdx.x * kHistThreads; b < n;
         b += (long long)gridDim.x * kHistThreads) {
      const long long i = b + tid;
      const bool valid = i < n;
      count_digits(valid ? __ldg(keys + i) : 0u, valid, sh, nrows, r0, hist);
    }
  }
  __syncthreads();
  for (int r = 0; r < total; ++r) {
    const uint32_t c = hist[r][tid];
    if (c != 0u) atomicAdd(table + r * kRadix + tid, c);
  }
}

template <bool kSlots>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
onesweep_kernel(Lanes lanes, int num_lanes, int key_lane, long long n, int shift,
                uint32_t* __restrict__ slots, const uint32_t* __restrict__ digit_counts,
                unsigned long long* __restrict__ lookback,
                uint32_t* __restrict__ tile_counter, uint32_t epoch) {
  __shared__ uint32_t stage[kTile];           // the tile in (digit, rank) order
  __shared__ uint32_t warp_base[kWarps][kRadix];
  __shared__ uint32_t lanes_of[2][kWarps][kRadix];  // per item: lanes holding a digit
  __shared__ uint32_t out_base[kRadix];       // global slot - local slot, per digit
  __shared__ uint32_t scratch[kWarps];
  __shared__ uint32_t tile_shared;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lanemask_lt = (1u << lane) - 1u;

  if (tid == 0) tile_shared = atomicAdd(tile_counter, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    warp_base[w][tid] = 0u;
    lanes_of[0][w][tid] = 0u;
    lanes_of[1][w][tid] = 0u;
  }
  __syncthreads();
  const uint32_t tile = tile_shared;
  const long long tile_start = (long long)tile * kTile;
  const long long warp_start = tile_start + (long long)warp * kWarpKeys;
  const bool full = tile_start + kTile <= n;  // no row past n: every lane valid
  const uint32_t* keys_in = pick(lanes.in, key_lane);

  uint32_t key[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = warp_start + 32 * j + lane;
    key[j] = (full || i < n) ? __ldg(keys_in + i) : 0u;
  }
  // this pass's digit bases, the exclusive scan of its 256 digit totals,
  // while the keys are on their way
  const uint32_t digit_base = rj::block_exclusive_scan<kThreads>(
      digit_counts[tid], 0u, rj::SumOp(), scratch, (uint32_t*)nullptr);

  // each warp's digit counts first, so the tile's counts are published
  // before the ranking
  uint32_t* counter = warp_base[warp];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (full || warp_start + 32 * j + lane < n)
      atomicAdd(counter + ((key[j] >> shift) & 0xFFu), 1u);
  }
  __syncthreads();

  // each digit's count in the tile, published at once; the warps'
  // exclusive prefix and the digit's start in the tile
  uint32_t count = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_base[w][tid];
    warp_base[w][tid] = count;
    count += c;
  }
  unsigned long long* mine = lookback + (long long)tile * kRadix + tid;
  publish(mine, epoch, tile == 0 ? kInclusive : kAggregate, count);
  const uint32_t digit_start = rj::block_exclusive_scan<kThreads>(
      count, 0u, rj::SumOp(), scratch, (uint32_t*)nullptr);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_base[w][tid] += digit_start;
  __syncthreads();

  // rank item by item: a key's local slot is its warp's next slot for its
  // digit plus the lanes below with that digit, so slots follow input
  // order within a digit.  The lanes of equal digit (what __match_any_sync
  // gives) gather in a shared word by atomicOr; the lowest of them advances
  // the counter and clears the word, which item j + 2 uses again.
  // info = digit << kSlotBits | slot, or kInvalid.
  uint32_t info[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = full || warp_start + 32 * j + lane < n;
    const uint32_t d = (key[j] >> shift) & 0xFFu;
    uint32_t* word = &lanes_of[j & 1][warp][d];
    if (valid) atomicOr(word, 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? *word : 0u;
    const int leader = __ffs(peers) - 1;
    __syncwarp();
    uint32_t next = 0u;
    if (lane == leader) {
      next = counter[d];
      counter[d] = next + (uint32_t)__popc(peers);
      *word = 0u;
    }
    const uint32_t slot =
        __shfl_sync(0xffffffffu, next, leader) + (uint32_t)__popc(peers & lanemask_lt);
    if (valid) {
      if (!kSlots) stage[slot] = key[j];
      info[j] = (d << kSlotBits) | slot;
    } else {
      info[j] = kInvalid;
    }
  }

  // decoupled look-back: keys of digit `tid` in the tiles before this one,
  // back to the first inclusive word, kLookBack words read at a time
  uint32_t before_tile = 0u;
  if (tile > 0) {
    long long t = (long long)tile - 1;
    bool done = false;
    while (!done) {
      unsigned long long w[kLookBack];
#pragma unroll
      for (int k = 0; k < kLookBack; ++k)
        w[k] = t - k >= 0 ? load_word(lookback + (t - k) * kRadix + tid) : 0ull;
      int k = 0;
#pragma unroll
      for (; k < kLookBack; ++k) {
        const uint32_t status = (uint32_t)(w[k] >> 32);
        if ((status >> 2) != epoch) break;  // wait on this one next
        before_tile += (uint32_t)w[k];
        if (status & kInclusive) {
          done = true;
          break;
        }
      }
      t -= k;
    }
    publish(mine, epoch, kInclusive, before_tile + count);
  }
  // uint32 arithmetic wraps, and base + slot lands in [0, n)
  out_base[tid] = digit_base + before_tile - digit_start;
  __syncthreads();

  constexpr uint32_t kSlotMask = (1u << kSlotBits) - 1u;
  if (kSlots) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (info[j] != kInvalid)
        slots[warp_start + 32 * j + lane] = out_base[info[j] >> kSlotBits] + (info[j] & kSlotMask);
    }
    return;
  }

  // the key lane, in digit runs: consecutive threads, consecutive slots
  const int tile_n = full ? kTile : (int)(n - tile_start);
  uint32_t dst[kItems];
  uint32_t* keys_out = pick(lanes.out, key_lane);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = r * kThreads + tid;
    if (i < tile_n) {
      const uint32_t k = stage[i];
      dst[r] = out_base[(k >> shift) & 0xFFu] + (uint32_t)i;
      keys_out[dst[r]] = k;
    }
  }
  // every other lane the same way, through the same stage
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l) {
    if (l >= num_lanes) break;
    if (l == key_lane) continue;
    const uint32_t* in = lanes.in[l];
    uint32_t* out = lanes.out[l];
    uint32_t v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      v[j] = info[j] != kInvalid ? __ldg(in + warp_start + 32 * j + lane) : 0u;
    }
    __syncthreads();  // the stage's previous lane is written out
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (info[j] != kInvalid) stage[info[j] & kSlotMask] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int i = r * kThreads + tid;
      if (i < tile_n) out[dst[r]] = stage[i];
    }
  }
}

}  // namespace

extern "C" {

// The [rows, 256] uint32 digit table of a sort, added into `table` (which
// the caller zeroes).  keys: num_keys (<= 4) device pointers to uint32 [n];
// key_rows: passes of each key lane; shifts: the shift of every row, rows
// of key lane k after those of lanes before it (<= 16 rows in all).
// Launches on `stream` and returns cudaGetLastError().
int rj_radix_histograms(const void* const* keys, const int* key_rows, const int* shifts,
                        int num_keys, long long n, void* table, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n > 0xFFFFFFFFll || num_keys < 1 || num_keys > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  HistRows rows;
  rows.num_keys = num_keys;
  rows.first_row[0] = 0;
  for (int k = 0; k < kMaxLanes; ++k) {
    const int add = k < num_keys ? key_rows[k] : 0;
    if (add < 0 || add > 4) return (int)cudaErrorInvalidValue;
    rows.keys[k] = k < num_keys ? static_cast<const uint32_t*>(keys[k]) : nullptr;
    rows.first_row[k + 1] = rows.first_row[k] + add;
  }
  const int total = rows.first_row[num_keys];
  if (total < 1 || total > kMaxPasses) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < kMaxPasses; ++r) {
    rows.shift[r] = r < total ? shifts[r] : 0;
    if (r < total && (rows.shift[r] < 0 || rows.shift[r] > 24 || rows.shift[r] % 8 != 0))
      return (int)cudaErrorInvalidValue;
  }
  // one wave of blocks, each striding over the lanes
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, histogram_kernel, kHistThreads, 0);
  const long long per_block = (long long)kHistThreads * kHistItems * 4;
  long long blocks = (n + per_block - 1) / per_block;
  const long long wave = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  histogram_kernel<<<(unsigned)blocks, kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n, static_cast<uint32_t*>(table));
  return (int)cudaGetLastError();
}

// One digit pass at `shift` over n keys, key lane lanes_in[key_lane].
// slots == null: moves all num_lanes (<= 4) lanes from lanes_in to
// lanes_out (host arrays of device pointers to uint32 [n], in and out
// distinct).  slots != null: writes each key's slot to uint32 slots[n] and
// moves nothing.  digit_counts: this pass's 256 totals (a row of the
// histogram table); lookback: num_tiles x 256 words of 8 bytes, zero or
// written by earlier passes of this sort; tile_counter: a uint32, zero;
// epoch: this pass's number within the sort plus one.  num_tiles must be
// ceil(n / kTile) (TILE_KEYS in ops/kernels/radix_sort.py).  Launches on
// `stream` and returns cudaGetLastError().
int rj_radix_onesweep_pass(const void* const* lanes_in, void* const* lanes_out, int num_lanes,
                           int key_lane, long long n, int shift, void* slots,
                           const void* digit_counts, void* lookback, long long num_tiles,
                           void* tile_counter, unsigned epoch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  if (n > 0xFFFFFFFFll || shift < 0 || shift > 24 || shift % 8 != 0 || num_lanes < 1 ||
      num_lanes > kMaxLanes || key_lane < 0 || key_lane >= num_lanes || epoch == 0u ||
      epoch > (0xFFFFFFFFu >> 2) || num_tiles != (n + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  Lanes lanes;
  for (int l = 0; l < kMaxLanes; ++l) {
    lanes.in[l] = l < num_lanes ? static_cast<const uint32_t*>(lanes_in[l]) : nullptr;
    lanes.out[l] = (l < num_lanes && slots == nullptr) ? static_cast<uint32_t*>(lanes_out[l])
                                                       : nullptr;
  }
  const uint32_t* counts = static_cast<const uint32_t*>(digit_counts);
  unsigned long long* lb = static_cast<unsigned long long*>(lookback);
  uint32_t* tc = static_cast<uint32_t*>(tile_counter);
  if (slots != nullptr) {
    onesweep_kernel<true><<<(unsigned)num_tiles, kThreads, 0, st>>>(
        lanes, num_lanes, key_lane, n, shift, static_cast<uint32_t*>(slots), counts, lb, tc,
        epoch);
  } else {
    onesweep_kernel<false><<<(unsigned)num_tiles, kThreads, 0, st>>>(
        lanes, num_lanes, key_lane, n, shift, nullptr, counts, lb, tc, epoch);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
