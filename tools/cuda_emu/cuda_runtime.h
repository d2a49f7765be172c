// A stand-in for <cuda_runtime.h> that runs a kernel of the port on the
// CPU, one std::thread per CUDA thread, for tools/cuda_emu.py. It checks
// a kernel's arithmetic, indexing and synchronisation before the card
// sees it; it says nothing of speed.
//
// - A launch runs the grid's CTAs one after the other; the threads of a
//   CTA run at once. __shared__ is static, so a CTA finds the last CTA's
//   shared memory, as a card may.
// - __syncthreads is a std::barrier over the CTA, __syncwarp one over the
//   warp; a thread that returns leaves both (arrive_and_drop), as an
//   exited thread no longer counts on the card. A named barrier (bar.sync
//   id, n) is a std::barrier of n made at its first arrival.
// - Shuffles go through a slot per lane: write, warp barrier, read, warp
//   barrier. Every lane of the warp must take part (the kernels shuffle
//   with the full mask only).
// - cp.async (tools/cuda_emu.py swaps the bodies of transform.cuh's
//   helpers for calls of emu::cp_async and the others): a copy is queued
//   and lands only at the cp_async_wait that retires its group, so a read
//   before the wait finds stale shared memory.
#pragma once
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <array>
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct uint3 {
  unsigned x, y, z;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(8) int2 {
  int x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline int2 make_int2(int x, int y) { return {x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}

typedef struct CUstream_st* cudaStream_t;
enum cudaError_t_ { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                    cudaErrorMisalignedAddress = 716 };
typedef int cudaError_t;
inline int cudaGetLastError() { return 0; }

using std::max;
using std::min;

namespace emu {

inline thread_local uint3 tid, bid;
inline dim3 grid, block;
inline std::barrier<>* cta_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
inline std::vector<std::array<uint64_t, 32>> slots;

inline int flat_tid() { return tid.x + block.x * (tid.y + block.y * tid.z); }
inline std::barrier<>& warp_bar() { return *warp_bars[flat_tid() / 32]; }

template <class T>
T shfl(T v, int src) {
  static_assert(sizeof(T) <= 8, "shuffle of a value over 8 bytes");
  const int t = flat_tid();
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  slots[t / 32][t % 32] = bits;
  warp_bar().arrive_and_wait();
  bits = slots[t / 32][src & 31];
  warp_bar().arrive_and_wait();
  T out;
  memcpy(&out, &bits, sizeof(T));
  return out;
}

// cp.async: the queued copies of this thread, by group
struct Copy {
  void* dst;
  const void* src;
  int bytes;
};
inline thread_local std::vector<Copy> open_group;
inline thread_local std::vector<std::vector<Copy>> committed;

inline void cp_async(void* smem, const void* gmem, int bytes) {
  if ((reinterpret_cast<uintptr_t>(smem) | reinterpret_cast<uintptr_t>(gmem))
      & (bytes - 1)) {
    fprintf(stderr, "cp.async of %d bytes misaligned: %p <- %p\n", bytes,
            smem, gmem);
    abort();
  }
  open_group.push_back({smem, gmem, bytes});
}
inline void cp_async_commit() {
  committed.push_back(open_group);
  open_group.clear();
}
inline void cp_async_wait(int pending) {
  while (static_cast<int>(committed.size()) > pending) {
    for (const Copy& c : committed.front()) memcpy(c.dst, c.src, c.bytes);
    committed.erase(committed.begin());
  }
}

// named barriers (bar.sync id, n), made by the first thread to arrive
inline std::mutex named_mu;
inline std::map<int, std::unique_ptr<std::barrier<>>> named;

inline void bar_sync(int id, int n) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> hold(named_mu);
    auto& slot = named[id];
    if (!slot) slot.reset(new std::barrier<>(n));
    b = slot.get();
  }
  b->arrive_and_wait();
}

template <class F>
void launch(dim3 g, dim3 b, F kernel) {
  grid = g;
  block = b;
  const int n = b.x * b.y * b.z, warps = (n + 31) / 32;
  for (unsigned z = 0; z < g.z; ++z)
    for (unsigned y = 0; y < g.y; ++y)
      for (unsigned x = 0; x < g.x; ++x) {
        std::barrier<> bar(n);
        cta_bar = &bar;
        warp_bars.clear();
        for (int w = 0; w < warps; ++w)
          warp_bars.emplace_back(
              new std::barrier<>(std::min(32, n - 32 * w)));
        slots.assign(warps, {});
        named.clear();
        std::vector<std::thread> threads;
        for (int t = 0; t < n; ++t)
          threads.emplace_back([&, t, x, y, z] {
            bid = {x, y, z};
            tid = {static_cast<unsigned>(t % b.x),
                   static_cast<unsigned>(t / b.x % b.y),
                   static_cast<unsigned>(t / (b.x * b.y))};
            kernel();
            if (!open_group.empty() || !committed.empty()) {
              fprintf(stderr, "a thread ended with cp.async in flight\n");
              abort();
            }
            warp_bar().arrive_and_drop();
            cta_bar->arrive_and_drop();
          });
        for (auto& th : threads) th.join();
      }
}

}  // namespace emu

#define threadIdx (emu::tid)
#define blockIdx (emu::bid)
#define blockDim (emu::block)
#define gridDim (emu::grid)

inline void __syncthreads() { emu::cta_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp_bar().arrive_and_wait();
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return emu::shfl(v, src);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu::shfl(v, (emu::flat_tid() % 32) ^ mask);
}
