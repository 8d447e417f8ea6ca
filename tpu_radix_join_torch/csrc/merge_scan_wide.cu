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
//
// Design: K3's one memset and one launch (merge_scan_partitions.cuh) over
// two or three lanes, each read once with 16-byte loads when the tile is
// whole and all of its lanes are aligned.  A run starts where the (lo, hi)
// pair differs from the pair before; the pair before a tile is read at
// start - 1 from both lanes.  The tile's three lanes would take 3 x 9,984 x
// 4 = 119,808 bytes of shared memory: dynamic shared memory allows that, but
// only one block an SM, and a third of the tile (3,328 positions) would
// triple the tiles' fixed costs (the counter, two block scans, the
// look-back).  So the lanes are folded into one word a position as they
// load (partition id, run start, side): 39,936 bytes, K3's tile and
// occupancy.  The null-hi template never reads or compares a hi lane.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints it): 50 registers with
// hi, 48 without, 40,560 bytes of shared memory each, no spills: five
// blocks an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_scan_partitions.cuh"

namespace {

// The lanes as merge_scan_partitions.cuh's load_words reads them; hi only
// when kWide.
template <bool kWide>
struct Lanes {
  struct Pos {
    uint32_t lo, hi, tag;
  };
  const uint32_t* __restrict__ lo;
  const uint32_t* __restrict__ hi;
  const uint32_t* __restrict__ tag;
  int fanout_bits;

  __device__ __forceinline__ Pos load(long long i) const {
    return Pos{__ldg(lo + i), kWide ? __ldg(hi + i) : 0u, __ldg(tag + i)};
  }
  __device__ __forceinline__ void load4(long long i, Pos* p) const {
    const uint4 l = __ldg(reinterpret_cast<const uint4*>(lo + i));
    const uint4 h = kWide ? __ldg(reinterpret_cast<const uint4*>(hi + i)) : make_uint4(0, 0, 0, 0);
    const uint4 g = __ldg(reinterpret_cast<const uint4*>(tag + i));
    p[0] = Pos{l.x, h.x, g.x};
    p[1] = Pos{l.y, h.y, g.y};
    p[2] = Pos{l.z, h.z, g.z};
    p[3] = Pos{l.w, h.w, g.w};
  }
  __device__ __forceinline__ bool aligned(long long i) const {
    const uintptr_t bits = (uintptr_t)(lo + i) | (uintptr_t)(tag + i) |
                           (kWide ? (uintptr_t)(hi + i) : (uintptr_t)0);
    return (bits & 15u) == 0;
  }
  __device__ __forceinline__ static Pos shfl_up(Pos p) {
    return Pos{__shfl_up_sync(0xffffffffu, p.lo, 1),
               kWide ? __shfl_up_sync(0xffffffffu, p.hi, 1) : 0u, 0u};
  }
  __device__ __forceinline__ static Pos unlike(Pos p) { return Pos{~p.lo, p.hi, p.tag}; }
  __device__ __forceinline__ uint32_t word(Pos p, Pos prev) const {
    return rj_bins::word(fanout_bits ? p.lo >> (32 - fanout_bits) : 0u,
                         p.lo != prev.lo || p.hi != prev.hi, p.tag & 1u);
  }
};

}  // namespace

extern "C" {

// lo_rot, tag: sorted uint32 [m], m < 2**31; hi: uint32 [m] or null (all
// zero); fanout_bits <= 30; scratch: one block of scratch_bytes bytes, K3's
// layout (rj_merge_scan).  Refuses any other size.  Zeroes the block with
// one memset, launches one kernel on `stream` and returns a cudaError_t.
int rj_merge_scan_wide(const void* lo_rot, const void* hi, const void* tag, long long m,
                       int fanout_bits, void* scratch, long long scratch_bytes, void* stream) {
  const uint32_t* l = static_cast<const uint32_t*>(lo_rot);
  const uint32_t* h = static_cast<const uint32_t*>(hi);
  const uint32_t* g = static_cast<const uint32_t*>(tag);
  return h != nullptr
             ? rj_bins::launch(Lanes<true>{l, h, g, fanout_bits}, m, fanout_bits, scratch,
                               scratch_bytes, stream)
             : rj_bins::launch(Lanes<false>{l, h, g, fanout_bits}, m, fanout_bits, scratch,
                               scratch_bytes, stream);
}

}  // extern "C"
