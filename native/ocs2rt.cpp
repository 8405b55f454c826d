// ocs2rt: native real-time runtime for the JAX-native OCS2 re-design.
//
// Re-implements, for the host side of the MPC<->MRT split, what the reference
// does with its C++ thread-support layer and ROS transport:
//   * lock-free double-buffered policy handoff   (reference BufferedValue.h:46,
//     Synchronized.h:111, and the flattened-policy topic
//     ocs2_msgs/msg/mpc_flattened_controller.msg) -> a seqlock blob store,
//     optionally in POSIX shared memory so MPC and MRT can live in different
//     processes (the ROS pub/sub analogue without a broker);
//   * real-time rate loops with deadline accounting (reference
//     ExecuteAndSleep.h, MRT_ROS_Dummy_Loop.cpp:58-180);
//   * RT thread priority (reference SetThreadPriority.h);
//   * monotonic timing for benchmark timers (reference Benchmark.h:42).
//
// The accelerator does the math; this layer keeps the 400 Hz control side
// honest.
// Exposed as a plain C ABI consumed from Python via ctypes
// (ocs2_tpu/runtime/native.py).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x0c52727475ULL;  // "ocs2rtu"

struct StoreHeader {
  uint64_t magic;
  uint64_t capacity;
  std::atomic<uint64_t> seq;   // even = stable, odd = write in progress
  std::atomic<uint64_t> size;  // payload bytes of the latest write
};

struct Store {
  StoreHeader* hdr;
  uint8_t* payload;
  uint64_t capacity;
  bool owns_shm;
  char name[256];
  void* private_mem;  // non-null for in-process stores
};

struct RateLoop {
  double period_s;
  struct timespec next;
  uint64_t ticks;
  uint64_t missed;
};

inline void timespec_add(struct timespec* t, double seconds) {
  const long nsec = static_cast<long>(seconds * 1e9);
  t->tv_nsec += nsec;
  while (t->tv_nsec >= 1000000000L) {
    t->tv_nsec -= 1000000000L;
    t->tv_sec += 1;
  }
}

inline double timespec_diff(const struct timespec& a, const struct timespec& b) {
  return (a.tv_sec - b.tv_sec) + 1e-9 * (a.tv_nsec - b.tv_nsec);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Seqlock policy store (BufferedValue / flattened-controller analogue).
// name == nullptr or "" -> in-process store (malloc); otherwise POSIX shm
// (name must start with '/'), shared across processes.
// ---------------------------------------------------------------------------

void* ocs2rt_store_create(const char* name, uint64_t capacity, int create) {
  const uint64_t total = sizeof(StoreHeader) + capacity;
  Store* s = new (std::nothrow) Store();
  if (!s) return nullptr;
  std::memset(s, 0, sizeof(Store));
  s->capacity = capacity;

  if (name == nullptr || name[0] == '\0') {
    s->private_mem = ::operator new(total, std::nothrow);
    if (!s->private_mem) {
      delete s;
      return nullptr;
    }
    s->hdr = reinterpret_cast<StoreHeader*>(s->private_mem);
    new (s->hdr) StoreHeader();
    s->hdr->magic = kMagic;
    s->hdr->capacity = capacity;
    s->hdr->seq.store(0);
    s->hdr->size.store(0);
  } else {
    std::strncpy(s->name, name, sizeof(s->name) - 1);
    int flags = O_RDWR | (create ? O_CREAT : 0);
    int fd = shm_open(name, flags, 0600);
    if (fd < 0) {
      delete s;
      return nullptr;
    }
    if (create && ftruncate(fd, static_cast<off_t>(total)) != 0) {
      close(fd);
      delete s;
      return nullptr;
    }
    uint64_t map_total = total;
    if (!create) {
      // Attach: validate the creator's header BEFORE mapping the payload —
      // the caller's capacity may disagree with the creator's; mapping past
      // the shm object's end SIGBUSes on first touch, a smaller mapping
      // silently truncates.  Map just the header, adopt hdr->capacity, then
      // remap at the creator's size.
      void* hmem = mmap(nullptr, sizeof(StoreHeader), PROT_READ, MAP_SHARED, fd, 0);
      if (hmem == MAP_FAILED) {
        close(fd);
        delete s;
        return nullptr;
      }
      const StoreHeader* peek = reinterpret_cast<const StoreHeader*>(hmem);
      const uint64_t magic = peek->magic;
      const uint64_t creator_capacity = peek->capacity;
      munmap(hmem, sizeof(StoreHeader));
      if (magic != kMagic) {
        close(fd);
        delete s;
        return nullptr;
      }
      s->capacity = creator_capacity;  // adopt (exposed via ocs2rt_store_capacity)
      map_total = sizeof(StoreHeader) + creator_capacity;
    }
    void* mem =
        mmap(nullptr, map_total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) {
      delete s;
      return nullptr;
    }
    s->hdr = reinterpret_cast<StoreHeader*>(mem);
    s->owns_shm = create != 0;
    if (create) {
      new (s->hdr) StoreHeader();
      s->hdr->magic = kMagic;
      s->hdr->capacity = capacity;
      s->hdr->seq.store(0);
      s->hdr->size.store(0);
    }
  }
  s->payload = reinterpret_cast<uint8_t*>(s->hdr) + sizeof(StoreHeader);
  return s;
}

void ocs2rt_store_close(void* handle, int unlink_shm) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return;
  if (s->private_mem) {
    ::operator delete(s->private_mem);
  } else {
    munmap(s->hdr, sizeof(StoreHeader) + s->capacity);
    if (unlink_shm && s->name[0]) shm_unlink(s->name);
  }
  delete s;
}

// Seqlock write: bump to odd, copy, bump to even.  Single-writer.
int ocs2rt_store_write(void* handle, const void* data, uint64_t size) {
  Store* s = static_cast<Store*>(handle);
  if (!s || size > s->capacity) return -1;
  uint64_t seq = s->hdr->seq.load(std::memory_order_relaxed);
  s->hdr->seq.store(seq + 1, std::memory_order_release);  // odd: in progress
  std::atomic_thread_fence(std::memory_order_release);
  std::memcpy(s->payload, data, size);
  s->hdr->size.store(size, std::memory_order_release);
  s->hdr->seq.store(seq + 2, std::memory_order_release);  // even: stable
  return 0;
}

// Seqlock read: retry until a consistent snapshot is observed.  Returns the
// payload size, 0 when nothing has ever been written, -1 on error, -2 when
// the sequence equals last_seq (no new data).  *seq_out receives the
// sequence of the returned snapshot.
int64_t ocs2rt_store_read(void* handle, void* out, uint64_t max_size,
                          uint64_t last_seq, uint64_t* seq_out) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return -1;
  for (int attempt = 0; attempt < 1000; ++attempt) {
    uint64_t s0 = s->hdr->seq.load(std::memory_order_acquire);
    if (s0 == 0) return 0;           // never written
    if (s0 & 1) continue;            // write in progress
    if (s0 == last_seq) return -2;   // unchanged
    uint64_t size = s->hdr->size.load(std::memory_order_acquire);
    if (size > max_size) return -1;
    std::memcpy(out, s->payload, size);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s1 = s->hdr->seq.load(std::memory_order_acquire);
    if (s0 == s1) {
      if (seq_out) *seq_out = s1;
      return static_cast<int64_t>(size);
    }
  }
  return -1;
}

uint64_t ocs2rt_store_seq(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return s ? s->hdr->seq.load(std::memory_order_acquire) : 0;
}

// Effective capacity of the store (on attach this is the CREATOR's capacity,
// which may differ from the capacity passed to ocs2rt_store_create).
uint64_t ocs2rt_store_capacity(void* handle) {
  Store* s = static_cast<Store*>(handle);
  return s ? s->capacity : 0;
}

// ---------------------------------------------------------------------------
// Real-time rate loop (ExecuteAndSleep / MRT dummy-loop analogue).
// ---------------------------------------------------------------------------

void* ocs2rt_rate_create(double period_s) {
  RateLoop* r = new (std::nothrow) RateLoop();
  if (!r) return nullptr;
  r->period_s = period_s;
  r->ticks = 0;
  r->missed = 0;
  clock_gettime(CLOCK_MONOTONIC, &r->next);
  timespec_add(&r->next, period_s);
  return r;
}

// Sleep until the next tick.  Returns the number of missed deadlines skipped
// (0 when on time).
int ocs2rt_rate_wait(void* handle) {
  RateLoop* r = static_cast<RateLoop*>(handle);
  if (!r) return -1;
  struct timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  int missed = 0;
  while (timespec_diff(now, r->next) > 0.0) {  // already past the deadline
    timespec_add(&r->next, r->period_s);
    ++missed;
  }
  if (missed > 0) r->missed += missed;
  while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &r->next, nullptr) ==
         EINTR) {
  }
  timespec_add(&r->next, r->period_s);
  ++r->ticks;
  return missed;
}

uint64_t ocs2rt_rate_ticks(void* handle) {
  RateLoop* r = static_cast<RateLoop*>(handle);
  return r ? r->ticks : 0;
}

uint64_t ocs2rt_rate_missed(void* handle) {
  RateLoop* r = static_cast<RateLoop*>(handle);
  return r ? r->missed : 0;
}

void ocs2rt_rate_destroy(void* handle) {
  delete static_cast<RateLoop*>(handle);
}

// ---------------------------------------------------------------------------
// Timing & thread utilities.
// ---------------------------------------------------------------------------

double ocs2rt_monotonic_time() {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

// Set SCHED_FIFO priority on the calling thread (SetThreadPriority.h);
// returns 0 on success (typically needs CAP_SYS_NICE).
int ocs2rt_set_realtime_priority(int priority) {
  sched_param param;
  param.sched_priority = priority;
  return pthread_setschedparam(pthread_self(), SCHED_FIFO, &param);
}

}  // extern "C"
