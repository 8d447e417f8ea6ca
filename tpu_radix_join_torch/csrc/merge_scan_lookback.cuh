// The single-pass tile carry of the merge scans: K6 (merge_scan_chunks.cu),
// K3 and K5 (merge_scan_partitions.cuh).
//
// Over a sorted packed union (key << 1 | side, side 0 for R and 1 for S),
// every S position weighs the number of R tuples in its equal-key run:
//   c_r[i]      = inclusive count of R up to i
//   base_run[i] = cummax over run starts j <= i of (c_r[j] - is_r[j])
//   weight[i]   = is_s[i] * (c_r[i] - base_run[i])
// A tile of positions summarises itself as (R, B): its R count and the
// largest run-start base inside it, relative to the tile (-1 when no run
// starts there).  Tiles compose in position order with
//   (R1, B1) + (R2, B2) = (R1 + R2, max(B1, B2 >= 0 ? R1 + B2 : -1)),
// which is associative but not commutative, with identity (0, -1).  The
// composition of every tile before a tile is the (c_r, base_run) carried
// into it.  The previous key needs no carry: it is read from memory at
// position start - 1.
//
// A block publishes its tile's summary, then looks back over its
// predecessors by decoupled look-back (Merrill & Garland, 2016), one warp
// reading 32 words at a time and composing them in tile order, and
// publishes the inclusive value.  Positions stay below 2**31, so R and B + 1
// each fit 31 bits beside a 2-bit flag: a status word is one relaxed 8-byte
// store (lookback.cuh).  Tiles come from an atomic counter, so a block never
// waits on a tile that is not running.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace rj_carry {

// status word: flag in bits 62-63, R in bits 31-61, B + 1 in bits 0-30
constexpr unsigned long long kAggregate = 1ull;
constexpr unsigned long long kInclusive = 2ull;
constexpr int kFlagShift = 62;
constexpr int kRShift = 31;
constexpr uint32_t kField = 0x7FFFFFFFu;

struct Carry {
  uint32_t r;  // R tuples
  int base;    // largest run-start base, -1 for none
};

__device__ __forceinline__ Carry identity() { return Carry{0u, -1}; }

// a, then b, in position order
__device__ __forceinline__ Carry compose(Carry a, Carry b) {
  return Carry{a.r + b.r, max(a.base, b.base >= 0 ? (int)a.r + b.base : -1)};
}

__device__ __forceinline__ unsigned long long status_word(unsigned long long flag, Carry c) {
  return (flag << kFlagShift) | ((unsigned long long)c.r << kRShift) |
         (unsigned long long)(uint32_t)(c.base + 1);
}

__device__ __forceinline__ unsigned long long flag_of(unsigned long long w) {
  return w >> kFlagShift;
}

__device__ __forceinline__ Carry carry_of(unsigned long long w) {
  return Carry{(uint32_t)(w >> kRShift) & kField, (int)((uint32_t)w & kField) - 1};
}

// Called by one whole warp.  Publishes tile `tile`'s summary `agg` in
// table[tile], resolves the composition of every tile before it (returned
// to every lane), and publishes the inclusive value.
__device__ __forceinline__ Carry lookback(unsigned long long* table, uint32_t tile, Carry agg) {
  const int lane = threadIdx.x & 31;
  unsigned long long* mine = table + tile;
  if (tile == 0u) {
    if (lane == 0) rj::store_relaxed(mine, status_word(kInclusive, agg));
    return identity();
  }
  if (lane == 0) rj::store_relaxed(mine, status_word(kAggregate, agg));
  Carry acc = identity();  // the tiles after j and before `tile`, composed
  long long j = (long long)tile - 1;
  while (true) {
    // lane l reads tile j - l; wait until every such word is published
    const long long k = j - lane;
    unsigned long long w;
    bool ready;
    do {
      w = k >= 0 ? rj::load_relaxed(table + k) : 0ull;
      ready = k < 0 || flag_of(w) != 0ull;
    } while (!__all_sync(0xffffffffu, ready));
    // the nearest inclusive word ends the walk: lanes 0 .. last compose
    const unsigned incl = __ballot_sync(0xffffffffu, k >= 0 && flag_of(w) == kInclusive);
    const int last = incl != 0u ? __ffs(incl) - 1 : 31;
    Carry v = (k >= 0 && lane <= last) ? carry_of(w) : identity();
    // lane l ends up with lanes [l, 32) composed, higher lanes (earlier
    // tiles) first
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      Carry u;
      u.r = __shfl_down_sync(0xffffffffu, v.r, o);
      u.base = __shfl_down_sync(0xffffffffu, v.base, o);
      if (lane + o < 32) v = compose(u, v);
    }
    Carry window;
    window.r = __shfl_sync(0xffffffffu, v.r, 0);
    window.base = __shfl_sync(0xffffffffu, v.base, 0);
    acc = compose(window, acc);
    if (incl != 0u) break;
    j -= 32;
  }
  if (lane == 0) rj::store_relaxed(mine, status_word(kInclusive, compose(acc, agg)));
  return acc;
}

}  // namespace rj_carry
