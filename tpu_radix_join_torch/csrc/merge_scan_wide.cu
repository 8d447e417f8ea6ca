// K5: the wide merge-weight scan of the full-range and 64-bit sort probes.
//
// Replaces tpu_radix_join/ops/pallas/merge_scan.py::merge_scan_partitions_wide
// (_kernel_partitions_wide).  Input: the sorted three-lane union
// (lo_rot, hi, tag): lo_rot is the low key lane rotated so the partition id
// sits in its top f bits, hi the upper key lane (null: all zero, the
// full-range uint32 probe), tag 0 for the inner (R) and 1 for the outer (S)
// relation, R before S inside every run of equal (lo, hi) pairs.  Every S
// position weighs the number of R tuples in its run:
//   c_r[i]      = inclusive count of R up to i
//   base_run[i] = cummax over run starts j <= i of (c_r[j] - is_r[j])
//   weight[i]   = is_s[i] * (c_r[i] - base_run[i])
// Output: per-partition uint32 sums of the weights (wrapping mod 2**32 like
// the TPU's int32 sums) and the largest single weight.  Any length works:
// the TPU kernel's tile multiple and its all-ones pad triple were Mosaic's
// requirements.  The TPU kernel compared x ^ 0x80000000 as int32 because
// Mosaic has no unsigned compare; here the lanes compare as uint32_t.
//
// Bound on the H100: bytes.  The function must read each lane once, 3 x 4 m
// bytes (2 x 4 m with no hi lane) at 3.35 TB/s; the outputs are P + 1 words.
// This design reads the lanes twice plus two words per block.
//
// Design: K3's (csrc/merge_scan.cu) three launches over three lanes.
//   * the previous (lo, hi) pair needs no carry: it is read from memory at
//     position i - 1;
//   * c_r is a cross-block prefix sum and base_run a cross-block prefix max:
//     summary_kernel writes per tile the R count and the largest run-start
//     base inside the tile (relative to the tile, -1 when no run starts),
//     carry_kernel (one block) scans them into each tile's carried
//     (c_r, base), and weight_kernel recomputes the tile with its carries,
//     sums per partition in shared memory (partition ids are sorted, so a
//     thread adds to shared memory only where the id changes), and ends with
//     one atomicAdd per touched partition and one atomicMax for the weight.
// The tile is staged in shared memory lane by lane: 3 lanes x kTile words =
// 27,648 bytes, inside the 48 KB static limit (K3's kItems = 15 would need
// 46 KB for three lanes).  Each thread owns kItems consecutive positions
// (odd, so its shared-memory reads hit distinct banks).  A run of equal keys
// longer than a tile is carried through base_run, never walked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 9;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr int kMaxBins = 128;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;

// The tile's lanes in shared memory; the hi lane only when kWide.
template <bool kWide>
struct Tile {
  uint32_t lo[kTile];
  uint32_t hi[kWide ? kTile : 1];
  uint32_t tag[kTile];
  uint32_t prev_lo, prev_hi;  // the pair before the tile (kNoKey before 0)
};

template <bool kWide>
__device__ __forceinline__ uint32_t hi_at(const Tile<kWide>& t, int j) {
  if constexpr (kWide) return t.hi[j];
  return 0u;
}

// Load a tile into shared memory; returns its valid length.
template <bool kWide>
__device__ __forceinline__ int load_tile(const uint32_t* __restrict__ lo,
                                         const uint32_t* __restrict__ hi,
                                         const uint32_t* __restrict__ tag, long long m,
                                         Tile<kWide>& t) {
  const long long start = (long long)blockIdx.x * kTile;
  const long long rest = m - start;
  const int valid = rest < kTile ? (int)rest : kTile;
  for (int k = threadIdx.x; k < valid; k += kThreads) {
    t.lo[k] = __ldg(lo + start + k);
    if constexpr (kWide) t.hi[k] = __ldg(hi + start + k);
    t.tag[k] = __ldg(tag + start + k);
  }
  if (threadIdx.x == 0) {
    t.prev_lo = start > 0 ? __ldg(lo + start - 1) : kNoKey;
    if constexpr (kWide) t.prev_hi = start > 0 ? __ldg(hi + start - 1) : kNoKey;
    else t.prev_hi = 0u;
  }
  __syncthreads();
  return valid;
}

// The pair before position `first` of the tile.
template <bool kWide>
__device__ __forceinline__ void prev_pair(const Tile<kWide>& t, int first, uint32_t* plo,
                                          uint32_t* phi) {
  *plo = first == 0 ? t.prev_lo : t.lo[first - 1];
  *phi = first == 0 ? t.prev_hi : hi_at(t, first - 1);
}

// The thread's own positions [first, last) of the tile: its R count and the
// R count before its last run start (-1 when no run starts there).
template <bool kWide>
__device__ __forceinline__ void thread_summary(const Tile<kWide>& t, int first, int last,
                                               uint32_t plo, uint32_t phi,
                                               uint32_t* count_r, int* last_start) {
  uint32_t c = 0u;
  int start = -1;
  for (int j = first; j < last; ++j) {
    const uint32_t lo = t.lo[j];
    const uint32_t hi = hi_at(t, j);
    if (lo != plo || hi != phi) start = (int)c;
    c += 1u - t.tag[j];
    plo = lo;
    phi = hi;
  }
  *count_r = c;
  *last_start = start;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
               const uint32_t* __restrict__ tag, long long m,
               uint32_t* __restrict__ tile_r, int* __restrict__ tile_base) {
  __shared__ Tile<kWide> t;
  __shared__ uint32_t scratch_u[kWarps];
  __shared__ int scratch_i[kWarps];
  const int valid = load_tile(lo, hi, tag, m, t);
  const int first = threadIdx.x * kItems;
  const int last = min(first + kItems, valid);
  uint32_t count_r = 0u;
  int last_start = -1;
  if (first < last) {
    uint32_t plo, phi;
    prev_pair(t, first, &plo, &phi);
    thread_summary(t, first, last, plo, phi, &count_r, &last_start);
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

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
weight_kernel(const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
              const uint32_t* __restrict__ tag, long long m,
              const uint32_t* __restrict__ carry_r, const int* __restrict__ carry_base,
              int fanout_bits, uint32_t* __restrict__ counts,
              uint32_t* __restrict__ max_weight) {
  __shared__ Tile<kWide> t;
  __shared__ uint32_t scratch_u[kWarps];
  __shared__ int scratch_i[kWarps];
  __shared__ uint32_t bins[kMaxBins];
  __shared__ uint32_t block_maxw;
  for (int b = threadIdx.x; b < kMaxBins; b += kThreads) bins[b] = 0u;
  if (threadIdx.x == 0) block_maxw = 0u;
  const int valid = load_tile(lo, hi, tag, m, t);  // synchronises
  const int first = threadIdx.x * kItems;
  const int last = min(first + kItems, valid);
  uint32_t plo = kNoKey, phi = kNoKey;
  uint32_t count_r = 0u;
  int last_start = -1;
  if (first < last) {
    prev_pair(t, first, &plo, &phi);
    thread_summary(t, first, last, plo, phi, &count_r, &last_start);
  }
  const uint32_t c_r0 = carry_r[blockIdx.x] +
      rj::block_exclusive_scan<kThreads>(count_r, 0u, rj::SumOp(), scratch_u,
                                         (uint32_t*)nullptr);
  const int cand = last_start >= 0 ? (int)c_r0 + last_start : -1;
  const int base0 = max(carry_base[blockIdx.x],
                        rj::block_exclusive_scan<kThreads>(cand, -1, rj::MaxOp(), scratch_i,
                                                           (int*)nullptr));
  uint32_t maxw = 0u;
  if (first < last) {
    const int pid_shift = 32 - fanout_bits;
    uint32_t c_r = c_r0;
    uint32_t base = (uint32_t)base0;
    uint32_t cur_pid = fanout_bits ? t.lo[first] >> pid_shift : 0u;
    uint32_t acc = 0u;
    for (int j = first; j < last; ++j) {
      const uint32_t l = t.lo[j];
      const uint32_t h = hi_at(t, j);
      const uint32_t is_s = t.tag[j];
      c_r += 1u - is_s;
      if (l != plo || h != phi) base = c_r - (1u - is_s);
      plo = l;
      phi = h;
      const uint32_t w = is_s * (c_r - base);
      const uint32_t pid = fanout_bits ? l >> pid_shift : 0u;
      if (pid != cur_pid) {
        if (acc != 0u) atomicAdd(bins + cur_pid, acc);
        cur_pid = pid;
        acc = 0u;
      }
      acc += w;
      maxw = w > maxw ? w : maxw;
    }
    if (acc != 0u) atomicAdd(bins + cur_pid, acc);
  }
  maxw = rj::warp_reduce(maxw, rj::MaxOp());
  if ((threadIdx.x & 31) == 0 && maxw != 0u) atomicMax(&block_maxw, maxw);
  __syncthreads();
  const int num_bins = 1 << fanout_bits;
  for (int b = threadIdx.x; b < num_bins; b += kThreads) {
    if (bins[b] != 0u) atomicAdd(counts + b, bins[b]);
  }
  if (threadIdx.x == 0 && block_maxw != 0u) atomicMax(max_weight, block_maxw);
}

template <bool kWide>
cudaError_t launch(const uint32_t* lo, const uint32_t* hi, const uint32_t* tag, long long m,
                   int fanout_bits, uint32_t* counts, uint32_t* max_weight,
                   uint32_t* scratch, long long nt, cudaStream_t st) {
  uint32_t* tile_r = scratch;
  int* tile_base = reinterpret_cast<int*>(scratch + nt);
  uint32_t* carry_r = scratch + 2 * nt;
  int* carry_base = reinterpret_cast<int*>(scratch + 3 * nt);
  summary_kernel<kWide><<<(unsigned)nt, kThreads, 0, st>>>(lo, hi, tag, m, tile_r, tile_base);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<<<1, kCarryThreads, 0, st>>>((int)nt, tile_r, tile_base, carry_r, carry_base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  weight_kernel<kWide><<<(unsigned)nt, kThreads, 0, st>>>(lo, hi, tag, m, carry_r, carry_base,
                                                          fanout_bits, counts, max_weight);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch the caller allocates for m positions: num_tiles words each of
// tile_r, tile_base, carry_r and carry_base.
long long rj_merge_scan_wide_num_tiles(long long m) { return (m + kTile - 1) / kTile; }

// lo_rot, tag: sorted uint32 [m]; hi: uint32 [m] or null (all zero);
// counts: uint32 [1 << fanout_bits]; max_weight: uint32 [1]; scratch:
// 4 * num_tiles uint32 words.  Zeroes the outputs, launches on `stream` and
// returns cudaGetLastError().
int rj_merge_scan_wide(const void* lo_rot, const void* hi, const void* tag, long long m,
                       int fanout_bits, void* counts, void* max_weight, void* scratch,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fanout_bits < 0 || fanout_bits > 7 || m < 0 || m > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(uint32_t) << fanout_bits, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(max_weight, 0, sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return (int)cudaGetLastError();
  const long long nt = rj_merge_scan_wide_num_tiles(m);
  const uint32_t* l = static_cast<const uint32_t*>(lo_rot);
  const uint32_t* h = static_cast<const uint32_t*>(hi);
  const uint32_t* g = static_cast<const uint32_t*>(tag);
  uint32_t* c = static_cast<uint32_t*>(counts);
  uint32_t* w = static_cast<uint32_t*>(max_weight);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  err = h != nullptr ? launch<true>(l, h, g, m, fanout_bits, c, w, s, nt, st)
                     : launch<false>(l, h, g, m, fanout_bits, c, w, s, nt, st);
  return (int)err;
}

}  // extern "C"
