// Device helpers shared by the intra kernels K3 (intra_dec.cu) and K4
// (intra_enc.cu): the predictors of ops/intra.py for the coded mode only.
// Their row schedule is K2's (wavefront.cuh).
#pragma once

#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace intra {

using rows::publish;
using rows::wait_row;

constexpr int NTHREADS = 32;   // one warp per CTA
constexpr int WPAD = 8;        // the working planes' zero margin

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

// one sample of a directional mode: a row (i0, i1, i2, w0, w1, w2, rnd,
// sh) of a _TAB4 / _TAB8 table over the edge vector e
__device__ __forceinline__ int table_sample(const int* row, const int* e) {
  return clamp255((row[3] * e[row[0]] + row[4] * e[row[1]] +
                   row[5] * e[row[2]] + row[6]) >> row[7]);
}

// Plane prediction (ops/intra._plane_pred) of sample (x, y) of an
// n x n block, from left column `l` and top row `t` at stride `ls` / 1.
__device__ __forceinline__ int plane_sample(const int* l, int ls,
                                            const int* t, int tl, int n,
                                            int x, int y) {
  const int h = n / 2;
  int H = 0, V = 0;
  for (int i = 1; i <= h; ++i) {
    H += i * (t[h - 1 + i] - (i < h ? t[h - 1 - i] : tl));
    V += i * (l[(h - 1 + i) * ls] - (i < h ? l[(h - 1 - i) * ls] : tl));
  }
  int b, c;
  if (n == 16) {
    b = (5 * H + 32) >> 6;
    c = (5 * V + 32) >> 6;
  } else {
    b = (17 * H + 16) >> 5;
    c = (17 * V + 16) >> 5;
  }
  const int a = 16 * (l[(n - 1) * ls] + t[n - 1]);
  return clamp255((a + b * (x - h + 1) + c * (y - h + 1) + 16) >> 5);
}

// intra chroma (mode 0 DC, 1 H, 2 V, 3 plane) of one 8x8 plane: sample p
__device__ __forceinline__ int chroma_pred(const int (&c)[9][9], int mode,
                                           bool aL, bool aT, int p) {
  const int y = p >> 3, x = p & 7;
  if (mode == 1) return c[1 + y][0];
  if (mode == 2) return c[0][1 + x];
  if (mode == 3) return plane_sample(&c[1][0], 9, &c[0][1], c[0][0], 8, x, y);
  const int qy = y >> 2, qx = x >> 2;
  int ls = 0, ts = 0;
  for (int i = 0; i < 4; ++i) {
    ls += c[1 + qy * 4 + i][0];
    ts += c[0][1 + qx * 4 + i];
  }
  if (qy == qx) {
    if (aL && aT) return (ls + ts + 4) >> 3;
    if (aT) return (ts + 2) >> 2;
    if (aL) return (ls + 2) >> 2;
    return 128;
  }
  if (qy == 0) {   // (0, 1): the top first
    if (aT) return (ts + 2) >> 2;
    if (aL) return (ls + 2) >> 2;
    return 128;
  }
  if (aL) return (ls + 2) >> 2;   // (1, 0): the left first
  if (aT) return (ts + 2) >> 2;
  return 128;
}

}  // namespace intra
