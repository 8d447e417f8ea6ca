// The single-pass, partition-binned merge scan of the sort probes, shared by
// K3 (merge_scan.cu: one packed lane) and K5 (merge_scan_wide.cu: the
// (lo_rot, hi, tag) lanes, hi optional).
//
// Over a sorted union every S position weighs the number of R tuples in its
// run of equal keys (merge_scan_lookback.cuh has the recurrence and the tile
// carry), and the weights are summed by partition, the top f bits of the key
// (f <= 30: a word below holds the pid in 30 bits).  Sums wrap mod 2**32 like
// the TPU's int32 sums; the largest single weight is kept beside them.
//
// One launch.  A block claims the next tile of kTile positions from a counter
// and reads its lanes once, with 16-byte loads when the tile is whole and
// every lane it reads is 16-byte aligned (4-byte loads otherwise).  As it
// loads, it folds each position into one word in shared memory,
//   word = pid << 2 | run_start << 1 | is_s,
// comparing the position's key with the key before it: the one a neighbour
// lane loaded (a warp shuffle), or, for lane 0 of a warp, the one position
// before its chunk, which it loads itself (the previous warp or block read
// that line, so it comes from L1 or L2).  Position 0 always starts a run.  So
// a tile costs one word of shared memory a position whatever its lanes, and
// K5's three lanes fit the tile of K6 (merge_scan_chunks.cu).  Then, as K6
// does: each thread owns kItems consecutive words (odd, so its reads hit
// distinct banks) and summarises them as (R, B); two block scans give the
// tile's summary and every thread's place in it; warp 0 carries the tiles
// before by decoupled look-back while the other warps wait at the barrier;
// every thread weighs its words and adds to shared per-partition bins only
// where the partition id changes (ids are sorted).  The block ends with one
// atomicAdd per touched bin and one atomicMax for the weight.  A run of equal
// keys longer than a tile is carried through B, never walked.
//
// Past 128 partitions (f > 7, the wide fanouts) the same kernel bins
// relative to the tile's first pid: the union is sorted pid-major, so a tile
// covers one contiguous pid range, and the kMaxBins shared bins hold the
// pids [first, first + 128) of the tile; a pid past them (a tile that spans
// more than 128 partitions: short partitions) adds its thread's sum straight
// to the global count with one atomic where the pid changes.  So a tile
// zeroes and flushes 128 bins at every fanout, not 2**f.  The f <= 7 path is
// the kWideBins = false instance, unchanged.
//
// The look-back table, the tile counter, the max weight and the partition
// counts are one scratch block (scratch_bytes), zeroed by one memset.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "merge_scan_lookback.cuh"

namespace rj_bins {

using rj_carry::Carry;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 39;
constexpr int kTile = kThreads * kItems;  // SCAN_TILE in ops/kernels/merge_scan.py
constexpr int kChunks = kTile / 4;        // 16-byte chunks of one lane
constexpr int kMaxBins = 128;             // shared bins: every pid at fanout_bits <= 7
constexpr int kMaxFanoutBits = 30;        // the pid's bits in a word
static_assert(kTile % 32 == 0 && (kChunks % kThreads) % 32 == 0,
              "every load loop's trip count is warp-uniform");

__host__ __device__ inline long long num_tiles(long long m) { return (m + kTile - 1) / kTile; }

// The scratch block's size in bytes (scratch_layout in ops/kernels/merge_scan.py):
// the look-back words, the tile counter, the max weight, the partition counts.
inline long long scratch_bytes(long long m, int fanout_bits) {
  return 8 * num_tiles(m) + 8 + 4 * (1ll << fanout_bits);
}

struct Scratch {
  unsigned long long* lookback;
  uint32_t* counter;
  uint32_t* max_weight;
  uint32_t* counts;
};

inline Scratch split(void* scratch, long long m) {
  unsigned long long* lookback = static_cast<unsigned long long*>(scratch);
  uint32_t* tail = reinterpret_cast<uint32_t*>(lookback + num_tiles(m));
  return Scratch{lookback, tail, tail + 1, tail + 2};
}

__device__ __forceinline__ uint32_t word(uint32_t pid, bool run_start, uint32_t is_s) {
  return pid << 2 | (uint32_t)run_start << 1 | is_s;
}

struct Shared {
  __align__(16) uint32_t words[kTile];
  uint32_t bins[kMaxBins];
  uint32_t scratch_u[kWarps];
  int scratch_i[kWarps];
  uint32_t red[kWarps];
  uint32_t tile;
  Carry carry;
};

// Adds a thread's sum acc of partition pid to the shared bins; on the wide
// path the bins start at the tile's first pid, and a pid past them adds to
// the global count.
template <bool kWideBins>
__device__ __forceinline__ void add_bin(Shared& s, const Scratch& out, uint32_t pid,
                                        uint32_t first_pid, uint32_t acc) {
  if (!kWideBins) {
    atomicAdd(s.bins + pid, acc);
  } else if (pid - first_pid < (uint32_t)kMaxBins) {
    atomicAdd(s.bins + (pid - first_pid), acc);
  } else {
    atomicAdd(out.counts + pid, acc);
  }
}

// Fills s.words with the words of tile t and returns its valid length.  L is
// the kernel's lanes: Pos (one position), load(i), load4(i, p) (positions
// i .. i + 3, i a multiple of 4), aligned(i) (every lane read at i is 16-byte
// aligned), shfl_up(p) (the key of the lane below), unlike(p) (a key that
// differs from p's) and word(p, prev).  Every thread calls it.
template <class L>
__device__ __forceinline__ int load_words(Shared& s, const L& in, long long m, uint32_t t) {
  using Pos = typename L::Pos;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long start = (long long)t * kTile;
  const int valid = (int)min((long long)kTile, m - start);
  if (valid == kTile && in.aligned(start)) {
    uint4* dst = reinterpret_cast<uint4*>(s.words);
#pragma unroll 2
    for (int c = tid; c < kChunks; c += kThreads) {
      const long long i = start + 4 * c;
      Pos p[4];
      in.load4(i, p);
      Pos prev = L::shfl_up(p[3]);
      if (lane == 0) prev = i > 0 ? in.load(i - 1) : L::unlike(p[0]);
      dst[c] = make_uint4(in.word(p[0], prev), in.word(p[1], p[0]), in.word(p[2], p[1]),
                          in.word(p[3], p[2]));
    }
  } else {
    const int padded = (valid + 31) & ~31;
    for (int k = tid; k < padded; k += kThreads) {
      const bool inside = k < valid;  // lane 0 is inside if any lane is
      const long long i = start + k;
      const Pos p = inside ? in.load(i) : Pos{};
      Pos prev = L::shfl_up(p);
      if (lane == 0 && inside) prev = i > 0 ? in.load(i - 1) : L::unlike(p);
      if (inside) s.words[k] = in.word(p, prev);
    }
  }
  __syncthreads();
  return valid;
}

// Weighs the tile's words, bins the weights by partition and adds the bins
// and the largest weight to the outputs.  kWideBins: the bins hold the pids
// from the tile's first on, and a pid past them adds to the global count.
// Every thread calls it.
template <bool kWideBins>
__device__ __forceinline__ void scan_words(Shared& s, uint32_t t, int valid, int fanout_bits,
                                           const Scratch& out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the thread's words [lo, hi): its R count and the R count before its
  // last run start (-1 when no run starts there)
  const int lo = tid * kItems;
  const int hi = min(lo + kItems, valid);
  uint32_t count_r = 0u;
  int last_start = -1;
  for (int j = lo; j < hi; ++j) {
    const uint32_t w = s.words[j];
    if (w & 2u) last_start = (int)count_r;
    count_r += 1u - (w & 1u);
  }
  uint32_t tile_r;
  const uint32_t excl_r =
      rj::block_exclusive_scan<kThreads>(count_r, 0u, rj::SumOp(), s.scratch_u, &tile_r);
  const int cand = last_start >= 0 ? (int)excl_r + last_start : -1;
  int tile_base;
  const int excl_base =
      rj::block_exclusive_scan<kThreads>(cand, -1, rj::MaxOp(), s.scratch_i, &tile_base);
  if (warp == 0) {
    const Carry before = rj_carry::lookback(out.lookback, t, Carry{tile_r, tile_base});
    if (lane == 0) s.carry = before;
  }
  __syncthreads();
  const Carry before = s.carry;

  // the state carried into the thread's first word; position 0 starts a
  // run, so base_run is defined wherever it is read
  uint32_t c_r = before.r + excl_r;
  const int b0 = max(before.base, excl_base >= 0 ? (int)before.r + excl_base : -1);
  uint32_t base = b0 >= 0 ? (uint32_t)b0 : 0u;
  uint32_t maxw = 0u;
  // the tile's first pid (its words are sorted pid-major): bin 0 of the
  // shared bins on the wide path
  const uint32_t first_pid = kWideBins ? s.words[0] >> 2 : 0u;
  if (lo < hi) {
    uint32_t pid = s.words[lo] >> 2;
    uint32_t acc = 0u;
    for (int j = lo; j < hi; ++j) {
      const uint32_t w = s.words[j];
      const uint32_t is_s = w & 1u;
      c_r += 1u - is_s;
      if (w & 2u) base = c_r - (1u - is_s);
      const uint32_t weight = is_s * (c_r - base);
      if ((w >> 2) != pid) {
        if (acc != 0u) add_bin<kWideBins>(s, out, pid, first_pid, acc);
        pid = w >> 2;
        acc = 0u;
      }
      acc += weight;
      maxw = weight > maxw ? weight : maxw;
    }
    if (acc != 0u) add_bin<kWideBins>(s, out, pid, first_pid, acc);
  }
  maxw = rj::warp_reduce(maxw, rj::MaxOp());
  if (lane == 0) s.red[warp] = maxw;
  __syncthreads();
  if (kWideBins) {
    for (int b = tid; b < kMaxBins; b += kThreads) {
      if (s.bins[b] != 0u) atomicAdd(out.counts + first_pid + b, s.bins[b]);
    }
  } else {
    for (int b = tid; b < (1 << fanout_bits); b += kThreads) {
      if (s.bins[b] != 0u) atomicAdd(out.counts + b, s.bins[b]);
    }
  }
  if (tid == 0) {
    uint32_t mx = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = s.red[w] > mx ? s.red[w] : mx;
    if (mx != 0u) atomicMax(out.max_weight, mx);
  }
}

template <class L, bool kWideBins>
__global__ void __launch_bounds__(kThreads)
scan_kernel(L in, long long m, int fanout_bits, Scratch out) {
  __shared__ Shared s;
  if (threadIdx.x == 0) s.tile = atomicAdd(out.counter, 1u);
  for (int b = threadIdx.x; b < kMaxBins; b += kThreads) s.bins[b] = 0u;
  __syncthreads();
  const uint32_t t = s.tile;
  const int valid = load_words(s, in, m, t);
  scan_words<kWideBins>(s, t, valid, fanout_bits, out);
}

// Checks the arguments and the scratch size, zeroes the scratch block with
// one memset and launches scan_kernel over m positions on `stream`: the
// 128-partition instance at fanout_bits <= 7, the wide-bins one past it.
// Returns a cudaError_t.
template <class L>
int launch(const L& in, long long m, int fanout_bits, void* scratch, long long bytes,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fanout_bits < 0 || fanout_bits > kMaxFanoutBits || m < 0 || m > 0x7FFFFFFFll ||
      bytes != scratch_bytes(m, fanout_bits))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)bytes, st);
  if (err != cudaSuccess || m == 0) return (int)(err != cudaSuccess ? err : cudaGetLastError());
  if (fanout_bits <= 7) {
    scan_kernel<L, false><<<(unsigned)num_tiles(m), kThreads, 0, st>>>(in, m, fanout_bits,
                                                                      split(scratch, m));
  } else {
    scan_kernel<L, true><<<(unsigned)num_tiles(m), kThreads, 0, st>>>(in, m, fanout_bits,
                                                                     split(scratch, m));
  }
  return (int)cudaGetLastError();
}

}  // namespace rj_bins
