// Multithreaded host-side relation generation: the port's copy of the JAX
// package's native/datagen.cc.
//
// Native replacement for the reference's data/Relation.cpp generators:
// fillUniqueValues (dense unique keys + shuffle, Relation.cpp:63-73,87-97),
// fillModuloValues (:75-85), plus the Zipf skew capability of the GPU data
// model (data/data.hpp:88).  The unique generator implements the same seeded
// Feistel-network bijection + cycle-walking as the JAX/numpy implementations
// (data/relation.py) - round keys are supplied by the caller so all three
// produce bit-identical permutations.  Parallelised with std::thread: every
// output index is independent, so this scales to 1B-tuple relations where a
// host Fisher-Yates shuffle (reference style) would serialize.

#include <cmath>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kFeistelRounds = 6;

struct FeistelParams {
  std::uint32_t keys[kFeistelRounds];
  std::uint32_t half_bits;
  std::uint64_t domain;       // 2**(2*half_bits)
  std::uint64_t global_size;  // cycle-walk target range
};

inline std::uint64_t feistel_once(std::uint64_t x, const FeistelParams& fp) {
  const std::uint64_t mask = (1ull << fp.half_bits) - 1;
  std::uint64_t l = x >> fp.half_bits;
  std::uint64_t r = x & mask;
  for (int i = 0; i < kFeistelRounds; ++i) {
    // Must match _feistel_round_np / _feistel in data/relation.py:
    // f = ((r * 0x9E3779B1 + k) ^ (r >> 7)) & mask  (uint32 wrap-around)
    std::uint64_t f =
        ((static_cast<std::uint32_t>(r * 0x9E3779B1u + fp.keys[i])) ^ (r >> 7)) &
        mask;
    std::uint64_t nl = r;
    r = (l ^ f) & mask;
    l = nl;
  }
  return (l << fp.half_bits) | r;
}

inline std::uint64_t permute(std::uint64_t idx, const FeistelParams& fp) {
  std::uint64_t v = feistel_once(idx, fp);
  while (v >= fp.global_size) v = feistel_once(v, fp);  // cycle-walk
  return v;
}

void run_threads(std::uint64_t count, int num_threads,
                 const std::function<void(std::uint64_t, std::uint64_t)>& fn) {
  if (num_threads <= 1) {
    fn(0, count);
    return;
  }
  std::vector<std::thread> ts;
  std::uint64_t chunk = (count + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    std::uint64_t lo = t * chunk;
    std::uint64_t hi = lo + chunk < count ? lo + chunk : count;
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// keys_out[i] = perm(start + i) for a seeded bijection of [0, global_size).
// round_keys: 6 uint32 Feistel round keys (from the caller's seeded RNG).
void fill_unique(std::uint32_t* keys_out, std::uint64_t start,
                 std::uint64_t count, std::uint64_t global_size,
                 std::uint32_t half_bits, const std::uint32_t* round_keys,
                 int num_threads) {
  FeistelParams fp;
  for (int i = 0; i < kFeistelRounds; ++i) fp.keys[i] = round_keys[i];
  fp.half_bits = half_bits;
  fp.domain = 1ull << (2 * half_bits);
  fp.global_size = global_size;
  run_threads(count, num_threads, [&](std::uint64_t lo, std::uint64_t hi) {
    for (std::uint64_t i = lo; i < hi; ++i) {
      keys_out[i] = static_cast<std::uint32_t>(permute(start + i, fp));
    }
  });
}

// keys_out[i] = (start + i) % modulo  (Relation::fillModuloValues).
void fill_modulo(std::uint32_t* keys_out, std::uint64_t start,
                 std::uint64_t count, std::uint32_t modulo, int num_threads) {
  run_threads(count, num_threads, [&](std::uint64_t lo, std::uint64_t hi) {
    for (std::uint64_t i = lo; i < hi; ++i) {
      keys_out[i] = static_cast<std::uint32_t>((start + i) % modulo);
    }
  });
}

// Zipf draw over [0, domain) from the integer-scaled tables the Python
// layer builds (data/relation.py zipf_tables): head ranks by upper-bound
// search of the 2^32-scaled uint32 CDF, tail ranks by linear interpolation
// of the 4097-entry inverse-CDF key table.  Every operation below is uint32
// arithmetic mirrored EXACTLY by zipf_keys_np (numpy) and zipf_range
// (device), so all three samplers are bit-identical (the float64 runs
// once, host-side, at table build).
// mix32 must match utils/hashing.py.
static inline std::uint32_t mix32(std::uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

void fill_zipf(std::uint32_t* keys_out, std::uint64_t start,
               std::uint64_t count, const std::uint32_t* head_cdf,
               std::uint64_t table_size, const std::uint32_t* tail_keys,
               std::uint64_t domain, std::uint64_t seed, int num_threads) {
  const std::uint32_t seed_mix =
      mix32(static_cast<std::uint32_t>(seed & 0xFFFFFFFFull));
  const std::uint32_t head_end = head_cdf[table_size - 1];
  const std::uint32_t dom_max = static_cast<std::uint32_t>(domain - 1);
  const bool has_tail = domain > table_size;
  run_threads(count, num_threads, [&](std::uint64_t lo, std::uint64_t hi) {
    for (std::uint64_t i = lo; i < hi; ++i) {
      const std::uint32_t u =
          mix32(static_cast<std::uint32_t>(start + i) ^ seed_mix);
      if (has_tail && u >= head_end) {
        // tail: second mixed draw supplies (segment, fraction) bits
        const std::uint32_t v = mix32(u ^ 0x9E3779B9u);
        const std::uint32_t j = v >> 20;
        const std::uint32_t frac = (v >> 8) & 0xFFFu;
        const std::uint32_t tk = tail_keys[j];
        const std::uint32_t d = tail_keys[j + 1] - tk;
        const std::uint32_t interp =
            (d >> 12) * frac + (((d & 0xFFFu) * frac) >> 12);
        const std::uint32_t s = tk + interp;   // may wrap near 2^32
        keys_out[i] = (s < tk) ? dom_max : (s < dom_max ? s : dom_max);
        continue;
      }
      // upper_bound: #{k : head_cdf[k] <= u} (== np.searchsorted right)
      std::uint64_t a = 0, b = table_size;
      while (a < b) {
        std::uint64_t m = (a + b) / 2;
        if (head_cdf[m] <= u) a = m + 1; else b = m;
      }
      if (a >= table_size) a = table_size - 1;
      keys_out[i] = static_cast<std::uint32_t>(a);
    }
  });
}

void fill_rids(std::uint32_t* rids_out, std::uint64_t start,
               std::uint64_t count, int num_threads) {
  run_threads(count, num_threads, [&](std::uint64_t lo, std::uint64_t hi) {
    for (std::uint64_t i = lo; i < hi; ++i) {
      rids_out[i] = static_cast<std::uint32_t>(start + i);
    }
  });
}

}  // extern "C"
