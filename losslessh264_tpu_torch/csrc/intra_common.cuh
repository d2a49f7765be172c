// Device helpers shared by the intra kernels K3 (intra_dec.cu) and K4
// (intra_enc.cu): the predictors of ops/intra.py with their per-MB
// parameters (DC sums, the plane's a, b, c) computed once per MB, the
// one-MB-ahead staging by cp.async and the named barrier of a warp group.
// Their row schedule is K2's (wavefront.cuh), with a block-wide publish.
#pragma once

#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace intra {

constexpr int WPAD = 8;        // the working planes' zero margin
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// ops/intra._dc: DC with the spec's neighbour-availability rules
__device__ __forceinline__ int dc_value(int lsum, int tsum, bool aL, bool aT,
                                        int n_log2) {
  if (aL && aT) return (lsum + tsum + (1 << n_log2)) >> (n_log2 + 1);
  if (aL) return (lsum + (1 << (n_log2 - 1))) >> n_log2;
  if (aT) return (tsum + (1 << (n_log2 - 1))) >> n_log2;
  return 128;
}

// one sample of a directional mode from a table row (i0, i1, i2, w0, w1,
// w2, rnd, sh) of _TAB4 / _TAB8 and the three edge samples it names
__device__ __forceinline__ int table_pred(const int* row, int e0, int e1,
                                          int e2) {
  return clamp255((row[3] * e0 + row[4] * e1 + row[5] * e2 + row[6]) >>
                  row[7]);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Plane prediction (ops/intra._plane_pred) of an n x n block: the
// parameters from the left column `l` (stride ls), the top row `t` and
// the top-left `tl`, then any sample (x, y) in a few operations.
struct Plane {
  int a, b, c, h;
  __device__ __forceinline__ int at(int x, int y) const {
    return clamp255((a + b * (x - h + 1) + c * (y - h + 1) + 16) >> 5);
  }
};

__device__ __forceinline__ Plane plane_params(const int* l, int ls,
                                              const int* t, int tl, int n) {
  const int h = n / 2;
  int H = 0, V = 0;
  for (int i = 1; i <= h; ++i) {
    H += i * (t[h - 1 + i] - (i < h ? t[h - 1 - i] : tl));
    V += i * (l[(h - 1 + i) * ls] - (i < h ? l[(h - 1 - i) * ls] : tl));
  }
  Plane p;
  if (n == 16) {
    p.b = (5 * H + 32) >> 6;
    p.c = (5 * V + 32) >> 6;
  } else {
    p.b = (17 * H + 16) >> 5;
    p.c = (17 * V + 16) >> 5;
  }
  p.a = 16 * (l[(n - 1) * ls] + t[n - 1]);
  p.h = h;
  return p;
}

// intra chroma (mode 0 DC, 1 H, 2 V, 3 plane) of one 8x8 plane whose
// context is c (row 0 the top with c[0][0] the top-left, column 0 the
// left): the four quadrants' DC values and the plane, once per MB
struct Chroma {
  int dc[4];   // quadrant (qy, qx) at 2 * qy + qx
  Plane pl;
};

__device__ __forceinline__ Chroma chroma_params(const int (&c)[9][9], bool aL,
                                                bool aT) {
  int l0 = 0, l1 = 0, t0 = 0, t1 = 0;
  for (int i = 0; i < 4; ++i) {
    l0 += c[1 + i][0];
    l1 += c[5 + i][0];
    t0 += c[0][1 + i];
    t1 += c[0][5 + i];
  }
  Chroma p;
  p.dc[0] = dc_value(l0, t0, aL, aT, 2);
  // (0, 1): the top first; (1, 0): the left first
  p.dc[1] = aT ? (t1 + 2) >> 2 : aL ? (l0 + 2) >> 2 : 128;
  p.dc[2] = aL ? (l1 + 2) >> 2 : aT ? (t0 + 2) >> 2 : 128;
  p.dc[3] = dc_value(l1, t1, aL, aT, 2);
  p.pl = plane_params(&c[1][0], 9, &c[0][1], c[0][0], 8);
  return p;
}

// sample p (raster) of chroma mode `mode`
__device__ __forceinline__ int chroma_at(const int (&c)[9][9], const Chroma& q,
                                         int mode, int p) {
  const int y = p >> 3, x = p & 7;
  if (mode == 1) return c[1 + y][0];
  if (mode == 2) return c[0][1 + x];
  if (mode == 3) return q.pl.at(x, y);
  return q.dc[(y >> 2) * 2 + (x >> 2)];
}

// a barrier of the `n` threads of warps that call it with the same id
// (1..15; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// 16 bytes global -> shared without registers (cp.async); both aligned
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most `n` of this thread's newest groups are in flight
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

}  // namespace intra
