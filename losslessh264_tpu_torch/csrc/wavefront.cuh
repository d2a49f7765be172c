// The persistent row schedule shared by the wavefront kernels K2
// (deblock.cu), K3 (intra_dec.cu) and K4 (intra_enc.cu): one-warp CTAs
// claim MB rows in order from a device counter (sync[0]); an MB that
// reads the row above waits until that row's progress counter reaches
// what it needs (an acquire load by lane 0), and the warp publishes its
// own progress after its stores (a fence, then a release store). Items
// are claimed in order by CTAs that are already running, so a CTA only
// ever waits on a row that a running CTA holds: no deadlock at any
// residency, and no cooperative launch. The intra kernels K3 and K4 run
// a CTA of several warps per row with the same claim order, so the
// argument holds for them unchanged: a CTA of any size waits only on a
// row that an earlier, running CTA holds. Their hand-off is block-wide
// (publish_block): every thread's stores, a barrier, then one thread's
// fence and release store.
#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace rows {

constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// wait until `prog` (the row above) has reached `need`; lane 0 polls
__device__ __forceinline__ void wait_row(const int* prog, int need, int& seen,
                                         int lane) {
  if (lane == 0)
    while (seen < need) seen = ld_acquire(prog);
  __syncwarp();
}

// publish `done` MBs of this row once every lane's stores are visible
__device__ __forceinline__ void publish(int* prog, int done, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0) st_release(prog, done);
}

// the same for a whole CTA: __syncthreads orders every thread's stores
// before thread 0's fence and release store
__device__ __forceinline__ void publish_block(int* prog, int done) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(prog, done);
  }
}

// Zero `sync_ints` ints of the sync scratch on `st`, then launch
// `kernel` with min(items, resident) CTAs of `threads` threads, where
// resident is the number of CTAs the current card holds at once (SMs x
// resident CTAs per SM, asked once per device and kept in `cache`).
// Returns the launch's cudaGetLastError().
template <typename... Params, typename... Args>
inline int launch_rows(void (*kernel)(Params...),
                       std::atomic<int> (&cache)[MAX_DEVICES], int threads,
                       int items, void* sync, size_t sync_ints,
                       cudaStream_t st, Args... args) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < MAX_DEVICES)
    resident = cache[dev].load(std::memory_order_relaxed);
  if (resident <= 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm > 1 ? sms * per_sm : 1;
    if (dev >= 0 && dev < MAX_DEVICES)
      cache[dev].store(resident, std::memory_order_relaxed);
  }
  err = cudaMemsetAsync(sync, 0, sizeof(int) * sync_ints, st);
  if (err != cudaSuccess) return (int)err;
  kernel<<<items < resident ? items : resident, threads, 0, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace rows
