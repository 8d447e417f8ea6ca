// Host memory pool: aligned bump allocator.
//
// The port's copy of the JAX package's native/pool.cc, the replacement for
// hpcjoin's memory/Pool.{h,cpp}: one posix_memalign'd region
// (Pool.cpp:25-38), 64B-aligned bump allocation (:40-64), overflow fallback
// to fresh aligned allocations (:55-59), and reset/free-all (:66-79).  The
// region starts on a page and spans whole pages, so it can be page-locked
// once (cudaHostRegister) and every chunk copied from it asynchronously;
// pool_base returns it for that.  Exposed to Python via ctypes
// (tpu_radix_join_torch/memory/pool.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

constexpr std::size_t kAlignment = 64;
constexpr std::size_t kPage = 4096;  // the region: whole pages, page-aligned

inline std::size_t round_up(std::size_t n, std::size_t a = kAlignment) {
  return (n + a - 1) & ~(a - 1);
}

struct Pool {
  std::uint8_t* base = nullptr;
  std::size_t capacity = 0;
  std::size_t offset = 0;
  std::vector<void*> overflow;  // fallback allocations (freed on reset)
  std::mutex mu;
};

}  // namespace

extern "C" {

// Returns an opaque pool handle, or null on allocation failure.
void* pool_create(std::size_t capacity) {
  void* mem = nullptr;
  capacity = round_up(capacity > 0 ? capacity : 1, kPage);
  if (posix_memalign(&mem, kPage, capacity) != 0) return nullptr;
  Pool* p = new Pool();
  p->base = static_cast<std::uint8_t*>(mem);
  p->capacity = capacity;
  return p;
}

// Bump-allocate `size` bytes (64B-aligned).  Falls back to a fresh aligned
// allocation when the region is exhausted, as the reference does.
void* pool_get_memory(void* handle, std::size_t size) {
  Pool* p = static_cast<Pool*>(handle);
  size = round_up(size);
  std::lock_guard<std::mutex> lock(p->mu);
  if (p->offset + size <= p->capacity) {
    void* out = p->base + p->offset;
    p->offset += size;
    return out;
  }
  void* mem = nullptr;
  if (posix_memalign(&mem, kAlignment, size) != 0) return nullptr;
  p->overflow.push_back(mem);
  return mem;
}

// Rewind the bump pointer and release overflow allocations (Pool::reset).
void pool_reset(void* handle) {
  Pool* p = static_cast<Pool*>(handle);
  std::lock_guard<std::mutex> lock(p->mu);
  p->offset = 0;
  for (void* mem : p->overflow) free(mem);
  p->overflow.clear();
}

std::size_t pool_used(void* handle) {
  Pool* p = static_cast<Pool*>(handle);
  std::lock_guard<std::mutex> lock(p->mu);
  return p->offset;
}

void* pool_base(void* handle) { return static_cast<Pool*>(handle)->base; }

std::size_t pool_capacity(void* handle) {
  return static_cast<Pool*>(handle)->capacity;
}

void pool_destroy(void* handle) {
  Pool* p = static_cast<Pool*>(handle);
  pool_reset(p);
  free(p->base);
  delete p;
}

}  // extern "C"
