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
// Design past 128 bins (the wide fanouts): one table per block in dynamic
// shared memory while num_bins <= kMaxSharedBins (128 KB: one or two blocks
// an SM), flushed like the narrow table; past that, atomics straight into
// the zeroed global table (L2 atomics, no flush).  The ids that verify's
// checksums and the bucket probe pass are often sorted or constant, so every
// lane of a warp hits one bin: a warp whose counted ids share one bin adds
// their count (or weight sum) once, as K4's histogram does
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
constexpr int kMaxSharedBins = 1 << 15;   // 128 KB of dynamic shared memory

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

// kShared: one num_bins table a block in dynamic shared memory, flushed at
// the end; else the adds go to the global table.  The loop bound is
// block-uniform, as the warp votes need.
template <bool kWeighted, bool kShared>
__global__ void __launch_bounds__(kWideThreads)
histogram_wide_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ weights,
                      long long n, int num_bins, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t table_s[];
  uint32_t* table = kShared ? table_s : out;
  if (kShared) {
    for (int b = threadIdx.x; b < num_bins; b += kWideThreads) table_s[b] = 0u;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * kWideThreads;
  for (long long base = (long long)blockIdx.x * kWideThreads; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    const bool inside = i < n;
    const uint32_t id = inside ? __ldg(ids + i) : 0xFFFFFFFFu;
    const uint32_t w = kWeighted && inside ? __ldg(weights + i) : 1u;
    add_warp<kWeighted>(table, inside && id < (uint32_t)num_bins, id, w);
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < num_bins; b += kWideThreads) {
      if (table_s[b] != 0u) atomicAdd(out + b, table_s[b]);
    }
  }
}

template <bool kWeighted, bool kShared>
cudaError_t launch_wide(const uint32_t* ids, const uint32_t* weights, long long n, int num_bins,
                        uint32_t* out, cudaStream_t st) {
  auto kernel = histogram_wide_kernel<kWeighted, kShared>;
  const size_t smem = kShared ? sizeof(uint32_t) * (size_t)num_bins : 0;
  // One wave of blocks at most, each striding over the ids.  The wave (SMs
  // times resident blocks at this table size) is queried once a thread,
  // device and size: a join launches the wide path several times alike.
  struct Wave {
    int device;
    size_t smem;
    long long blocks;
  };
  static thread_local Wave cached{-1, 0, 0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (cached.device != device || cached.smem != smem) {
    if (smem > 48 * 1024) {   // always the largest table, so no call lowers it
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(sizeof(uint32_t) * kMaxSharedBins));
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, smem);
    cached = {device, smem, (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1)};
  }
  const long long wave = cached.blocks;
  long long blocks = (n + (long long)kWideThreads * kWideItems - 1) / ((long long)kWideThreads * kWideItems);
  if (blocks > wave) blocks = wave;
  kernel<<<(unsigned)blocks, kWideThreads, smem, st>>>(ids, weights, n, num_bins, out);
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
// zeroes `out`, launches the wide kernel on `stream`; returns a cudaError_t.
extern "C" int rj_histogram_wide(const void* ids, const void* weights, long long n, int num_bins,
                                 void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_bins < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t) * (size_t)num_bins, st);
  if (err != cudaSuccess || n <= 0) return (int)(err != cudaSuccess ? err : cudaGetLastError());
  const uint32_t* k = static_cast<const uint32_t*>(ids);
  const uint32_t* w = static_cast<const uint32_t*>(weights);
  uint32_t* o = static_cast<uint32_t*>(out);
  const bool shared = num_bins <= kMaxSharedBins;
  if (w != nullptr) {
    err = shared ? launch_wide<true, true>(k, w, n, num_bins, o, st)
                 : launch_wide<true, false>(k, w, n, num_bins, o, st);
  } else {
    err = shared ? launch_wide<false, true>(k, nullptr, n, num_bins, o, st)
                 : launch_wide<false, false>(k, nullptr, n, num_bins, o, st);
  }
  return (int)err;
}
