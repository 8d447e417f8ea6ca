// K1: per-bin counts (or uint32 weight sums) of partition ids.
//
// Replaces tpu_radix_join/ops/pallas/histogram.py::histogram_pallas (_kernel),
// the TPU kernel that walked tiles in grid order and kept P scalar
// accumulators in SMEM.  Contract: ids >= num_bins are ignored, sums wrap
// modulo 2**32 exactly as the TPU's int32 accumulation did.  Two entries:
// rj_histogram for num_bins <= 128, rj_histogram_wide for any num_bins >= 1.
//
// Bound on the H100: bytes.  The kernel reads every id once (and every weight
// once in the weighted form) and writes num_bins words: 4 n (8 n) bytes at
// 3.35 TB/s, some 24 us for 20M ids.  The work per byte is one compare and one
// shared-memory add, far below the card's operation rate.
//
// Design, up to 128 bins: a grid-stride loop over the ids with one private
// 128-bin table per warp in shared memory, so concurrent shared atomics
// collide only inside a warp; at the end each block adds its non-zero bins
// into the global table with one atomicAdd per bin.  Sorted or constant ids
// (every id in one bin) cost the same as random ones up to the shared-atomic
// serialisation within a warp.
//
// Design past 128 bins (the wide fanouts), picked by num_bins alone (the
// wrapper, ops/kernels/histogram.py, mirrors the choice):
//   * up to kRangeMaxBins: range tables.  The bins are split into R =
//     ceil(num_bins / kMaxRangeBins) ranges, and a block holds one range's
//     table in dynamic shared memory (64 KB at most, three blocks an SM) and
//     strides over one chunk of the ids with 16-byte loads, adding the ids
//     of its range with shared-memory atomics, then adds its non-zero bins
//     into the zeroed global table.  The grid is one wave: R blocks a chunk,
//     so each id is read from device memory once and from L2 R times.  This
//     replaced one table a block of all the bins read with one 4-byte load
//     a thread and round (a table past 2**15 bins did not fit: L2 atomics
//     instead).  On 20M random ids (tools_k1_k4_profile.py, device time,
//     an H100 80GB HBM3 at 700 W) that took 46-48 us up to 4096 bins, 66
//     at 2**14 and 290-325 at 2**15 + 1 and 2**16; the range tables take
//     30-35, 42 and 75-90: the loads in flight, not the flush (4-6 us),
//     held the old loop back.  One table a thread-block cluster, split into
//     shards in its blocks' shared memory and added into through
//     distributed shared memory, took 250-650 us at 129 to 2**17 bins
//     (remote shared atomics); the tool keeps it as its cluster_dsmem
//     variant;
//   * past kRangeMaxBins (more than kMaxRanges ranges): atomics straight
//     into the zeroed global table (L2 atomics, no flush).
// The ids that verify's checksums and the bucket probe pass are often sorted
// or constant, so every lane of a warp hits one bin: a warp whose counted ids
// share one bin adds their count (or weight sum) once, as K4's histogram does
// (partition.cu: count_group), and otherwise each lane adds its own.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 128;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kWideThreads = 512;
constexpr int kWideItems = 16;            // ids a wide-path thread takes, at least
constexpr int kMaxRangeBins = 1 << 14;    // bins a block's range table holds at most (64 KB)
constexpr int kMaxRanges = 8;             // ranges at most; past them the global table
constexpr long long kRangeMaxBins = (long long)kMaxRanges * kMaxRangeBins;
constexpr int kVec = 2;                   // 16-byte loads a range-path thread takes a round

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ weights,
                 long long n, int num_bins, uint32_t* __restrict__ out) {
  __shared__ uint32_t bins[kWarps][kMaxBins];
  for (int i = threadIdx.x; i < kWarps * kMaxBins; i += kThreads) (&bins[0][0])[i] = 0u;
  __syncthreads();
  uint32_t* mine = bins[threadIdx.x >> 5];
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const uint32_t id = __ldg(ids + i);
    if (id < (uint32_t)num_bins) atomicAdd(mine + id, kWeighted ? __ldg(weights + i) : 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_bins; b += kThreads) {
    uint32_t s = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += bins[w][b];
    if (s != 0u) atomicAdd(out + b, s);
  }
}

// Adds each counted lane's weight (1 unweighted) to table[id].  A warp whose
// counted lanes share one id adds their sum once.  Every lane of the warp
// calls it.
template <bool kWeighted>
__device__ __forceinline__ void add_warp(uint32_t* table, bool counted, uint32_t id, uint32_t w) {
  const unsigned lanes = __ballot_sync(0xffffffffu, counted);
  if (lanes == 0u) return;
  const int first = __ffs(lanes) - 1;
  const uint32_t id0 = __shfl_sync(0xffffffffu, id, first);
  if (__all_sync(0xffffffffu, !counted || id == id0)) {
    uint32_t sum = (uint32_t)__popc(lanes);
    if (kWeighted) {
      sum = counted ? w : 0u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if ((int)(threadIdx.x & 31) == first && sum != 0u) atomicAdd(table + id0, sum);
  } else if (counted && (!kWeighted || w != 0u)) {
    atomicAdd(table + id, kWeighted ? w : 1u);
  }
}

// Past the range tables: every counted id an atomic on the global table.
// The loop bound is block-uniform, as the warp votes need.
template <bool kWeighted>
__global__ void __launch_bounds__(kWideThreads)
histogram_global_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ weights,
                        long long n, int num_bins, uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kWideThreads;
  for (long long base = (long long)blockIdx.x * kWideThreads; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool inside = i < n;
    const uint32_t id = inside ? __ldg(ids + i) : 0xFFFFFFFFu;
    const uint32_t w = kWeighted && inside ? __ldg(weights + i) : 1u;
    add_warp<kWeighted>(out, inside && id < (uint32_t)num_bins, id, w);
  }
}

// The blocks of one wave of `kernel` with `smem` bytes of dynamic shared
// memory (SMs times resident blocks), queried once a thread, kernel, device
// and size: a join launches the wide path several times alike.
template <typename Kernel>
long long wave_blocks(Kernel kernel, size_t smem, cudaError_t* err) {
  struct Wave {
    const void* kernel;
    int device;
    size_t smem;
    long long blocks;
  };
  static thread_local Wave cached{nullptr, -1, 0, 0};
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  if (cached.kernel != key || cached.device != device || cached.smem != smem) {
    if (smem > 48 * 1024) {  // always the largest table, so no call lowers it
      *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)(sizeof(uint32_t) * kMaxRangeBins));
      if (*err != cudaSuccess) return 0;
    }
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, smem);
    cached = {key, device, smem, (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1)};
  }
  return cached.blocks;
}

// The blocks n ids need at kWideItems a thread, at least one.
long long blocks_for(long long n) {
  const long long b = (n + (long long)kWideThreads * kWideItems - 1) /
                      ((long long)kWideThreads * kWideItems);
  return b > 0 ? b : 1;
}

template <bool kWeighted>
cudaError_t launch_global(const uint32_t* ids, const uint32_t* weights, long long n, int num_bins,
                          uint32_t* out, cudaStream_t st) {
  auto kernel = histogram_global_kernel<kWeighted>;
  cudaError_t err;
  const long long wave = wave_blocks(kernel, 0, &err);
  if (err != cudaSuccess) return err;
  const long long blocks = blocks_for(n) < wave ? blocks_for(n) : wave;
  kernel<<<(unsigned)blocks, kWideThreads, 0, st>>>(ids, weights, n, num_bins, out);
  return cudaGetLastError();
}

// One table a block for a range of the bins: block b holds bins [r *
// range_bins, r * range_bins + count), r = b / chunks, in dynamic shared
// memory and strides over chunk b % chunks of the ids (16-byte loads over
// the aligned body, kVec a thread and round), adding the ids of its range
// (as add_warp, an id as its offset in the range).  The grid is one wave,
// so the R blocks of one chunk stride over it together and all but the
// first read it from L2; the ranges are range-major in the grid, so the
// blocks an SM holds belong to different ranges and ids of one range (a
// constant input) still spread over the SMs.  At the end each block adds
// its non-zero bins into the global table.  The loop bounds are
// block-uniform, as the warp votes need.
template <bool kWeighted>
__global__ void __launch_bounds__(kWideThreads)
histogram_range_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ weights,
                       long long n, int num_bins, int range_bins, int ranges,
                       uint32_t* __restrict__ out) {
  extern __shared__ uint32_t table_s[];
  const int tid = threadIdx.x;
  const long long chunks = gridDim.x / ranges;
  const long long chunk = blockIdx.x % chunks;
  const uint32_t lo = (uint32_t)(blockIdx.x / chunks) * (uint32_t)range_bins;
  const uint32_t count = (uint32_t)num_bins - lo < (uint32_t)range_bins
                             ? (uint32_t)num_bins - lo : (uint32_t)range_bins;
  for (uint32_t b = tid; b < count; b += kWideThreads) table_s[b] = 0u;
  __syncthreads();
  const bool aligned = ((uintptr_t)ids & 15u) == 0 &&
                       (!kWeighted || ((uintptr_t)weights & 15u) == 0);
  const long long nvec = aligned ? n / 4 : 0;
  const uint4* vid = reinterpret_cast<const uint4*>(ids);
  const uint4* vw = reinterpret_cast<const uint4*>(weights);
  const long long step = (long long)kWideThreads * kVec;
  // an id outside the range (or ~0u past n) wraps to an offset >= count,
  // as lo + count <= num_bins < 2**31
  for (long long b = chunk * step; b < nvec; b += chunks * step) {
    uint4 q[kVec], wq[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long v = b + (long long)j * kWideThreads + tid;
      const bool inside = v < nvec;
      q[j] = inside ? __ldg(vid + v) : make_uint4(~0u, ~0u, ~0u, ~0u);
      wq[j] = kWeighted && inside ? __ldg(vw + v) : make_uint4(1u, 1u, 1u, 1u);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      add_warp<kWeighted>(table_s, q[j].x - lo < count, q[j].x - lo, wq[j].x);
      add_warp<kWeighted>(table_s, q[j].y - lo < count, q[j].y - lo, wq[j].y);
      add_warp<kWeighted>(table_s, q[j].z - lo < count, q[j].z - lo, wq[j].z);
      add_warp<kWeighted>(table_s, q[j].w - lo < count, q[j].w - lo, wq[j].w);
    }
  }
  for (long long b = 4 * nvec + chunk * kWideThreads; b < n; b += chunks * kWideThreads) {
    const long long i = b + tid;
    const bool inside = i < n;
    const uint32_t rel = (inside ? __ldg(ids + i) : ~0u) - lo;
    const uint32_t w = kWeighted && inside ? __ldg(weights + i) : 1u;
    add_warp<kWeighted>(table_s, rel < count, rel, w);
  }
  __syncthreads();
  for (uint32_t b = tid; b < count; b += kWideThreads) {
    const uint32_t v = table_s[b];
    if (v != 0u) atomicAdd(out + lo + b, v);
  }
}

template <bool kWeighted>
cudaError_t launch_range(const uint32_t* ids, const uint32_t* weights, long long n, int num_bins,
                         uint32_t* out, cudaStream_t st) {
  auto kernel = histogram_range_kernel<kWeighted>;
  const int ranges = (num_bins + kMaxRangeBins - 1) / kMaxRangeBins;
  const int range_bins = ((num_bins + ranges - 1) / ranges + 31) / 32 * 32;
  const size_t smem = sizeof(uint32_t) * (size_t)range_bins;
  cudaError_t err;
  long long chunks = wave_blocks(kernel, smem, &err) / ranges;
  if (err != cudaSuccess) return err;
  if (chunks > blocks_for(n)) chunks = blocks_for(n);
  if (chunks < 1) chunks = 1;
  kernel<<<(unsigned)(chunks * ranges), kWideThreads, smem, st>>>(ids, weights, n, num_bins,
                                                                 range_bins, ranges, out);
  return cudaGetLastError();
}

}  // namespace

// ids, weights (null for counts), out: device pointers to uint32 [n], [n],
// [num_bins].  Zeroes `out` and launches on `stream`; returns cudaGetLastError().
extern "C" int rj_histogram(const void* ids, const void* weights, long long n, int num_bins,
                            void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bins < 1 || num_bins > kMaxBins) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)num_bins, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    long long blocks = (n + kThreads * 16 - 1) / (kThreads * 16);
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const uint32_t* w = static_cast<const uint32_t*>(weights);
    if (w != nullptr) {
      histogram_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const uint32_t*>(ids), w, n, num_bins, static_cast<uint32_t*>(out));
    } else {
      histogram_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
          static_cast<const uint32_t*>(ids), nullptr, n, num_bins,
          static_cast<uint32_t*>(out));
    }
  }
  return (int)cudaGetLastError();
}

// The same contract for any num_bins >= 1 (the wrapper takes it past 128):
// zeroes `out`, launches the range tables (num_bins <= kRangeMaxBins) or the
// global table on `stream`; returns a cudaError_t.
extern "C" int rj_histogram_wide(const void* ids, const void* weights, long long n, int num_bins,
                                 void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bins < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)num_bins, st);
  if (err != cudaSuccess || n <= 0) return (int)(err != cudaSuccess ? err : cudaGetLastError());
  const uint32_t* k = static_cast<const uint32_t*>(ids);
  const uint32_t* w = static_cast<const uint32_t*>(weights);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (num_bins <= kRangeMaxBins) {
    err = w != nullptr ? launch_range<true>(k, w, n, num_bins, o, st)
                       : launch_range<false>(k, nullptr, n, num_bins, o, st);
  } else {
    err = w != nullptr ? launch_global<true>(k, w, n, num_bins, o, st)
                       : launch_global<false>(k, nullptr, n, num_bins, o, st);
  }
  return (int)err;
}
