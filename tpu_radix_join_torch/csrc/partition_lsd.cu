// K4 past the wide kernel's 8192 groups: a stable grouping of tuples by an id
// of any width.
//
// Replaces tpu_radix_join/ops/pallas/partition.py::partition_slots_pallas
// (_kernel) where num_groups > 8192 (partition_wide.cu holds 257..8192), the
// fanouts the TPU kernel's SMEM cursors never held (the JAX package falls
// back to its sort arm there).
// The contract is K4's (partition.cu): invalid ids (>= num_groups) are
// counted nowhere and dropped; dense mode gives a stable grouping
// permutation; blocked mode gives group_size consecutive groups a block of
// `capacity` slots, input order within a group, and a tuple whose unclipped
// position in its block is >= capacity gets 0xFFFFFFFF, so the clip eats a
// block's highest groups first; the totals are exact.
//
// Bound on the H100: bytes.  A grouping must read the ids and each moved lane
// once and write each output once: 4 n + 4 n L + 4 size L bytes.
//
// Design.  K4's onesweep cannot simply grow: its look-back table is tiles x
// groups words, and thread `tid` owns group `tid`; the wide kernel's shared
// tables hold 8192 groups.  But K4 is a stable
// grouping, and stable 8-bit LSD digit passes compose into one stable
// grouping by the full id, which is what K2 (radix_sort.cu) is.  So the wide
// path is, in the wrapper (ops/kernels/partition.py, _partition_lsd_cuda):
//   1. keys_kernel: every id becomes its group, num_groups for an invalid id
//      (the invalid group stays last), beside its input index;
//   2. K2 sorts (group, index) by the group, ceil(log2(num_groups + 1) / 8)
//      passes of two lanes;
//   3. K1's wide path counts the ids into the exact totals, whose exclusive
//      scan (a few thousand words, in PyTorch) gives each layout block's
//      first sorted position;
//   4. place_kernel turns each sorted position into its slot with the clip
//      (the plain version's formula: position - block start, kept below
//      capacity), or, when it moves lanes, walks the output slots in order
//      and gathers each slot's tuple from the sorted indices or writes the
//      lane's fill: every output slot is written once, pads included, with
//      consecutive threads on consecutive slots.
// The group never rides as a fifth lane: the lanes are gathered once, at
// the end, by index, so any number of them moves (four a launch).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 4;
constexpr uint32_t kDropped = 0xFFFFFFFFu;

struct Lanes {
  const uint32_t* in[kMaxLanes];
  uint32_t* out[kMaxLanes];
  uint32_t fill[kMaxLanes];
};

__global__ void __launch_bounds__(kThreads)
keys_kernel(const uint32_t* __restrict__ ids, long long n, uint32_t num_groups,
            uint32_t* __restrict__ keys, uint32_t* __restrict__ index) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const uint32_t id = __ldg(ids + i);
    keys[i] = id < num_groups ? id : num_groups;
    index[i] = (uint32_t)i;
  }
}

// slots[index[p]] for every sorted position p.  block_start[b]: the first
// sorted position of layout block b (group_size groups); capacity < 0 is
// dense mode, where a valid tuple's slot is its sorted position.
__global__ void __launch_bounds__(kThreads)
slots_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ index, long long n,
             uint32_t num_groups, uint32_t group_size, long long capacity,
             const long long* __restrict__ block_start, uint32_t* __restrict__ slots) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < n; p += stride) {
    const uint32_t g = __ldg(keys + p);
    uint32_t slot = kDropped;
    if (g < num_groups) {
      if (capacity < 0) {
        slot = (uint32_t)p;
      } else {
        const uint32_t b = g / group_size;
        const long long within = p - __ldg(block_start + b);
        if (within < capacity) slot = (uint32_t)((long long)b * capacity + within);
      }
    }
    slots[__ldg(index + p)] = slot;
  }
}

// Every output slot x of the layout: block b = x / region, offset w; the
// tuple at sorted position block_start[b] + w while w is below the block's
// count (and the region), else the fill.  Dense mode is one region of n
// slots whose count is the valid total.
__global__ void __launch_bounds__(kThreads)
move_kernel(const uint32_t* __restrict__ index, long long out_size, long long region,
            const long long* __restrict__ block_start, Lanes lanes, int num_lanes) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long x = (long long)blockIdx.x * kThreads + threadIdx.x; x < out_size; x += stride) {
    const long long b = x / region;
    const long long w = x - b * region;
    const long long first = __ldg(block_start + b);
    const bool filled = w < __ldg(block_start + b + 1) - first;
    const uint32_t src = filled ? __ldg(index + first + w) : 0u;
#pragma unroll
    for (int l = 0; l < kMaxLanes; ++l) {
      if (l >= num_lanes) break;
      lanes.out[l][x] = filled ? __ldg(lanes.in[l] + src) : lanes.fill[l];
    }
  }
}

long long grid_for(long long work) {
  // the SM count, queried once a thread and device
  static thread_local int cached_device = -1, sms = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device != cached_device) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached_device = device;
  }
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 1) * 16;
  return blocks < cap ? (blocks > 0 ? blocks : 1) : cap;
}

}  // namespace

extern "C" {

// ids: uint32 [n]; keys, index: uint32 [n] outputs, keys[i] = min(ids[i],
// num_groups) and index[i] = i.  Launches on `stream`; returns a cudaError_t.
int rj_partition_keys(const void* ids, long long n, int num_groups, void* keys, void* index,
                      void* stream) {
  if (n < 0 || n > 0xFFFFFFFFll || num_groups < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  keys_kernel<<<(unsigned)grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ids), n, (uint32_t)num_groups, static_cast<uint32_t*>(keys),
      static_cast<uint32_t*>(index));
  return (int)cudaGetLastError();
}

// The groups `keys` (sorted, stable) and their input indices `index` of n
// tuples; block_start: int64 [regions + 1] first sorted positions of the
// layout blocks (dense: {0, valid total}).  capacity < 0 is dense mode.
// slots != null: writes uint32 slots[n] and moves nothing.  slots == null:
// moves num_lanes (<= 4) lanes (host arrays of device pointers; inputs of n,
// outputs of out_size) and writes every other output slot with fills[lane].
// Launches on `stream`; returns a cudaError_t.
int rj_partition_place(const void* keys, const void* index, long long n, int num_groups,
                       int group_size, long long capacity, const void* block_start, void* slots,
                       int num_lanes, const void* const* lanes_in, void* const* lanes_out,
                       const unsigned* fills, long long out_size, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || n > 0xFFFFFFFFll || num_groups < 1 || group_size < 1 ||
      num_groups % group_size != 0 || num_lanes < 0 || num_lanes > kMaxLanes || capacity == 0)
    return (int)cudaErrorInvalidValue;
  const long long* starts = static_cast<const long long*>(block_start);
  if (slots != nullptr) {
    if (n == 0) return (int)cudaGetLastError();
    slots_kernel<<<(unsigned)grid_for(n), kThreads, 0, st>>>(
        static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(index), n,
        (uint32_t)num_groups, (uint32_t)group_size, capacity, starts,
        static_cast<uint32_t*>(slots));
    return (int)cudaGetLastError();
  }
  const long long region = capacity < 0 ? n : capacity;
  if (out_size == 0 || num_lanes == 0) return (int)cudaGetLastError();
  Lanes lanes{};
  for (int l = 0; l < num_lanes; ++l) {
    lanes.in[l] = static_cast<const uint32_t*>(lanes_in[l]);
    lanes.out[l] = static_cast<uint32_t*>(lanes_out[l]);
    lanes.fill[l] = fills[l];
  }
  move_kernel<<<(unsigned)grid_for(out_size), kThreads, 0, st>>>(
      static_cast<const uint32_t*>(index), out_size, region, starts, lanes, num_lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
