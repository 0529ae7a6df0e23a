// Host memory arena — the TPU-VM analog of the reference's persistent-
// memory JNI allocator (reference
// zoo/src/main/java/com/intel/analytics/zoo/pmem/PersistentMemoryAllocator.java:37-42
// `@native initialize/allocate/free/copy`, backed by libmemkind on Optane).
//
// TPU VMs have no Optane; the role of the tier — a large, cheaply
// allocated, sequentially filled sample cache that bypasses the Python
// allocator — is played by an mmap-backed bump arena with an atomic
// offset, safe for concurrent ingest threads.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

#include <sys/mman.h>

namespace {

struct Arena {
  uint8_t* base;
  size_t capacity;
  std::atomic<size_t> used;
};

constexpr size_t kBad = ~static_cast<size_t>(0);

}  // namespace

extern "C" {

void* arena_create(size_t capacity) {
  void* mem = mmap(nullptr, capacity, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (mem == MAP_FAILED) return nullptr;
  Arena* a = new (std::nothrow) Arena{static_cast<uint8_t*>(mem),
                                      capacity, {0}};
  if (!a) {
    munmap(mem, capacity);
    return nullptr;
  }
  return a;
}

void arena_destroy(void* handle) {
  if (!handle) return;
  Arena* a = static_cast<Arena*>(handle);
  munmap(a->base, a->capacity);
  delete a;
}

// Returns the offset of the allocation, or SIZE_MAX when full.
size_t arena_alloc(void* handle, size_t nbytes, size_t align) {
  Arena* a = static_cast<Arena*>(handle);
  if (align == 0) align = 64;
  size_t cur = a->used.load(std::memory_order_relaxed);
  size_t start, end;
  do {
    start = (cur + align - 1) & ~(align - 1);
    end = start + nbytes;
    if (end > a->capacity) return kBad;
  } while (!a->used.compare_exchange_weak(cur, end,
                                          std::memory_order_acq_rel));
  return start;
}

void* arena_base(void* handle) {
  return static_cast<Arena*>(handle)->base;
}

size_t arena_used(void* handle) {
  return static_cast<Arena*>(handle)->used.load(
      std::memory_order_acquire);
}

size_t arena_capacity(void* handle) {
  return static_cast<Arena*>(handle)->capacity;
}

void arena_reset(void* handle) {
  static_cast<Arena*>(handle)->used.store(0, std::memory_order_release);
}

// The analog of PersistentMemoryAllocator.copy: memcpy into the arena.
void arena_copy(void* handle, size_t offset, const void* src,
                size_t nbytes) {
  Arena* a = static_cast<Arena*>(handle);
  std::memcpy(a->base + offset, src, nbytes);
}

}  // extern "C"
