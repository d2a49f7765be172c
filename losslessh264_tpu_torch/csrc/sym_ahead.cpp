// Parse-ahead for the symbol layer (native.SymbolDecoder): one native
// thread per iterated decoder runs the handle's next and planes functions
// (pip_sym_next and pip_sym_planes, or the port's pip_pooled_next and
// pip_pooled_planes, sym_planes.cpp), through the function pointers the
// binding hands over, up to `depth` frames ahead of the consumer, each
// frame into one buffer of its own. next returns 2 for a frame parsed
// into planes that held as large a frame before, any other positive
// number for another frame; the frame's item carries which, and the
// thread's minor page faults during the parse. Plain C++17 for the host,
// built by g++ into build/host/libpip_plan.so (_build.host_lib) and
// called through ctypes.
//
// The thread never enters the interpreter, so it never waits for the
// interpreter lock nor makes the consumer wait for it: the consumer's
// only calls are pip_ahead_take, which blocks outside the lock while the
// thread is behind, and pip_ahead_stop. The thread owns the native
// handle from pip_ahead_start on and closes it when it leaves for good:
// after the stream's end or an error (before the consumer can take that
// item, so that what the handle keeps is free for the next one), or a
// stop. The worker state is freed by whichever of the two sides lets go
// of it last.
//
// A frame's buffer holds pip_sym_planes' 31 output buffers in its
// argument order, each at a 64-byte boundary; the binding computes the
// same layout from the same (bytes per MB, fixed bytes) table and hands
// the buffer back with pip_ahead_free once no array over it is left.
// Handed-back buffers are kept, up to kPoolBytes in all, for the next
// frames of the same size, in any decoder: a fresh allocation of
// megabytes faults in each of its pages when the copy-out first writes
// it (3.3-4.1 ms for an 8 MB 720p frame on the card's host, 1.3-1.7 ms
// into a kept buffer, which is faulted in already).

#include <pthread.h>
#include <sys/resource.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kBuffers = 31;  // pip_sym_planes' output buffers
constexpr int kMeta = 20;     // meta's place among them (int32 [12])

using NextFn = int (*)(void*, int*, int*, char*, size_t);
using PlanesFn = int (*)(void*, void*, void*, void*, void*, void*, void*,
                         void*, void*, void*, void*, void*, void*, void*,
                         void*, void*, void*, void*, void*, void*, void*,
                         void*, void*, void*, void*, void*, void*, void*,
                         void*, void*, void*, void*);
using CloseFn = void (*)(void*);

// what pip_ahead_take reports (its return value) besides a frame
enum : int { kNotReady = 2, kFrame = 1, kEnd = 0, kNextFailed = -1,
             kPlanesFailed = -2, kNoMemory = -3 };

std::atomic<int> g_live{0};  // worker threads running

constexpr size_t kPoolBytes = size_t(256) << 20;
std::mutex g_pool_m;
std::unordered_map<size_t, std::vector<void*>> g_pool;  // by size
size_t g_pool_bytes = 0;

void* buffer(size_t size) {
  {
    std::lock_guard<std::mutex> lk(g_pool_m);
    auto it = g_pool.find(size);
    if (it != g_pool.end() && !it->second.empty()) {
      void* p = it->second.back();
      it->second.pop_back();
      g_pool_bytes -= size;
      return p;
    }
  }
  return std::aligned_alloc(64, size);
}

void give_back(void* p, size_t size) {
  {
    std::lock_guard<std::mutex> lk(g_pool_m);
    if (g_pool_bytes + size <= kPoolBytes) {
      g_pool[size].push_back(p);
      g_pool_bytes += size;
      return;
    }
  }
  std::free(p);
}

int64_t minor_faults() {
  rusage ru;
  return getrusage(RUSAGE_THREAD, &ru) == 0 ? int64_t(ru.ru_minflt) : 0;
}

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

struct Frame {
  int rc = kEnd;
  int w = 0, h = 0;
  void* buf = nullptr;
  size_t size = 0;
  int64_t t[4] = {0, 0, 0, 0};  // parse start, parse end, alloc end, copy end
  int kept = 0;         // next returned 2
  int64_t faults = 0;   // the thread's minor page faults during next
  std::string err;
};

struct Ahead {
  void* h;
  NextFn next;
  PlanesFn planes;
  CloseFn close;
  size_t depth;
  int64_t per_mb[kBuffers];  // bytes per MB of each buffer
  int64_t fixed[kBuffers];   // bytes of each buffer whatever the size
  int64_t thread_id = 0;

  std::mutex m;
  std::condition_variable room;   // the thread waits for a free slot
  std::condition_variable ready;  // the consumer waits for a frame
  std::deque<Frame> q;
  bool stop = false;
  int refs = 2;  // the consumer's and the thread's
};

size_t padded(int64_t bytes) { return size_t((bytes + 63) / 64 * 64); }

void release(Ahead* a) {
  bool last;
  {
    std::lock_guard<std::mutex> lk(a->m);
    last = --a->refs == 0;
  }
  if (!last) return;
  for (Frame& f : a->q)
    if (f.buf) give_back(f.buf, f.size);
  delete a;
}

// One frame: parse, allocate, copy out.
Frame parse_one(Ahead* a) {
  Frame f;
  char err[512];
  err[0] = 0;
  const int64_t faults = minor_faults();
  f.t[0] = now_ns();
  int rc = a->next(a->h, &f.w, &f.h, err, sizeof err);
  f.t[1] = f.t[2] = f.t[3] = now_ns();
  f.faults = minor_faults() - faults;
  f.kept = rc == 2;
  if (rc == 0) return f;
  if (rc < 0) {
    f.rc = kNextFailed;
    f.err = err;
    return f;
  }
  const int64_t n = int64_t(f.w) * f.h;
  size_t off[kBuffers], size = 0;
  for (int i = 0; i < kBuffers; ++i) {
    off[i] = size;
    size += padded(a->per_mb[i] * n + a->fixed[i]);
  }
  uint8_t* buf = static_cast<uint8_t*>(buffer(size));
  f.t[2] = f.t[3] = now_ns();
  if (!buf) {
    f.rc = kNoMemory;
    return f;
  }
  void* p[kBuffers];
  for (int i = 0; i < kBuffers; ++i) p[i] = buf + off[i];
  rc = a->planes(a->h, p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                 p[9], p[10], p[11], p[12], p[13], p[14], p[15], p[16], p[17],
                 p[18], p[19], p[20], p[21], p[22], p[23], p[24], p[25],
                 p[26], p[27], p[28], p[29], p[30]);
  f.t[3] = now_ns();
  if (rc != 0) {
    give_back(buf, size);
    f.rc = kPlanesFailed;
    return f;
  }
  static_cast<int32_t*>(p[kMeta])[11] = 0;  // the one word not written
  f.rc = kFrame;
  f.buf = buf;
  f.size = size;
  return f;
}

void run(Ahead* a) {
  a->thread_id = int64_t(pthread_self());
  for (;;) {
    {
      std::unique_lock<std::mutex> lk(a->m);
      a->room.wait(lk, [a] { return a->stop || a->q.size() < a->depth; });
      if (a->stop) break;
    }
    Frame f = parse_one(a);
    const bool last = f.rc != kFrame;
    if (last) {
      a->close(a->h);
      a->h = nullptr;
    }
    {
      std::lock_guard<std::mutex> lk(a->m);
      a->q.push_back(std::move(f));
    }
    a->ready.notify_one();
    if (last) break;
  }
  if (a->h) a->close(a->h);
  release(a);
  g_live.fetch_sub(1);
}

}  // namespace

extern "C" {

// Start the worker of the open native handle `h`: the thread owns it from
// here on. sizes: [kBuffers] bytes per MB, then [kBuffers] fixed bytes.
// Returns 0 and the worker in *out, or 1 (the handle still the caller's)
// if no thread could be started.
int pip_ahead_start(void* h, void* next, void* planes, void* close,
                    int depth, const int64_t* sizes, void** out) {
  Ahead* a;
  try {
    a = new Ahead();
  } catch (...) {
    return 1;
  }
  a->h = h;
  a->next = reinterpret_cast<NextFn>(next);
  a->planes = reinterpret_cast<PlanesFn>(planes);
  a->close = reinterpret_cast<CloseFn>(close);
  a->depth = size_t(depth < 1 ? 1 : depth);
  std::memcpy(a->per_mb, sizes, sizeof a->per_mb);
  std::memcpy(a->fixed, sizes + kBuffers, sizeof a->fixed);
  g_live.fetch_add(1);
  try {
    std::thread(run, a).detach();
  } catch (...) {
    g_live.fetch_sub(1);
    delete a;
    return 1;
  }
  *out = a;
  return 0;
}

// The next item, in stream order, if `block` or if one is queued; returns
// kFrame (out: w, h, buffer, its size, the four times, the thread id,
// whether next parsed into planes that held as large a frame, the minor
// page faults during next),
// kEnd, kNextFailed (err: pip_sym_next's message), kPlanesFailed,
// kNoMemory (out's times and thread id set for each), or kNotReady. The
// caller takes nothing after an item other than a frame.
int pip_ahead_take(void* av, int block, int64_t* out, char* err,
                   size_t err_cap) {
  Ahead* a = static_cast<Ahead*>(av);
  Frame f;
  {
    std::unique_lock<std::mutex> lk(a->m);
    if (a->q.empty() && !block) return kNotReady;
    a->ready.wait(lk, [a] { return !a->q.empty(); });
    f = std::move(a->q.front());
    a->q.pop_front();
  }
  a->room.notify_one();
  out[0] = f.w;
  out[1] = f.h;
  out[2] = int64_t(reinterpret_cast<uintptr_t>(f.buf));
  out[3] = int64_t(f.size);
  for (int i = 0; i < 4; ++i) out[4 + i] = f.t[i];
  out[8] = a->thread_id;
  out[9] = f.kept;
  out[10] = f.faults;
  if (err && err_cap) {
    std::strncpy(err, f.err.c_str(), err_cap - 1);
    err[err_cap - 1] = 0;
  }
  return f.rc;
}

// Frames parsed and not yet taken.
int pip_ahead_queued(void* av) {
  Ahead* a = static_cast<Ahead*>(av);
  std::lock_guard<std::mutex> lk(a->m);
  return int(a->q.size());
}

// The consumer lets go: the thread stops before its next parse (a parse
// under way runs to its end), closes the handle and frees what is queued.
int pip_ahead_stop(void* av) {
  Ahead* a = static_cast<Ahead*>(av);
  {
    std::lock_guard<std::mutex> lk(a->m);
    a->stop = true;
  }
  a->room.notify_one();
  release(a);
  return 0;
}

// Hand back a frame's buffer of `size` bytes (pip_ahead_take handed it
// over).
int pip_ahead_free(void* buf, size_t size) {
  give_back(buf, size);
  return 0;
}

// Worker threads running in the process.
int pip_ahead_live() { return g_live.load(); }

}  // extern "C"
