// K2: the H.264 in-loop deblocking filter (spec 8.7) over a whole frame,
// as one persistent launch that walks the MB rows.
//
// Replaces the Pallas kernel deblock_wavefront / _kernel
// (losslessh264_tpu/ops/deblock_pallas.py:57-258). Plain torch version:
// losslessh264_tpu_torch/ops/deblock.py deblock_wavefront_plain.
//
// Layout: int32 working planes padded by WPAD = 8 on every side (luma
// [H+16, W+16], chroma [H/2+16, W/2+16]), so MB (r, x)'s 24x24 luma
// window (the MB with the 8 rows above and the 8 columns left of it)
// starts at plane row 16*r, column 16*x, and its 16x16 chroma windows at
// 8*r, 8*x. Per-MB filter parameters (bS, alpha, beta, tc0 per edge) come
// packed in one [n, 384] int32 row per MB, the layout of the TPU kernel's
// _pack_params (offsets below; lanes 344-383 are padding).
//
// What bounds it on the H100:
// - bytes: at 720p (80x45 MBs) the picture's int32 pixels (Y 720x1280,
//   U and V 360x640) read and written once are 11.06 MB, and the 344
//   used lanes of each MB's parameter row read once 4.95 MB: ~16.0 MB,
//   ~4.8 us at 3.35 TB/s. Edges on the picture's border are never
//   filtered, so the padding of the planes and of the rows is not needed
//   (chip_smoke.k2_bytes).
// - dependencies: MB (r, x) reads pixels that MBs (r-1, x-1..x+1) and
//   (r, x-1) modify, so a frame is a chain of 2*(mb_h-1)+mb_w dependent
//   MB steps (168 at 720p). Each step is 2x4 ordered edges and a hand-off
//   between SMs (a flag seen, the rows above read from L2, the MB's
//   stores made visible). That chain, at microseconds per step, bounds
//   the kernel, not the bytes.
// What the design does about each:
// - one launch per frame and no host schedule. A CTA is one warp. It
//   claims the next work item, one MB row of luma or of chroma (U and V
//   together), from a device counter (atomicAdd) and walks it left to
//   right. Before the part of MB (r, x) that reads row r-1, lane 0 waits,
//   with ld.acquire.gpu, until row r-1 of its plane kind has finished MBs
//   0..min(x+1, mb_w-1); after the MB the warp publishes progress = x+1
//   (__threadfence, then st.release.gpu). Items are claimed in order by
//   CTAs that are already running, so a CTA only ever waits on a row that
//   a running CTA holds: no deadlock at any residency, and no
//   cooperative launch. The C entry zeroes the counters on the stream.
// - a short step. Luma and chroma are separate chains on separate SMs:
//   in one warp they would diverge and run one after the other. The
//   vertical edges of an MB read and write only its own pixel rows, which
//   no MB of row r-1 touches, so they run before the wait; only the
//   horizontal edges, which read the rows above, come after it. The MB's
//   interior and parameter row are modified by no MB that runs before it,
//   so cp.async fetches them (16 bytes at a time) one MB ahead. The rows
//   above come through L2 (__ldcg) straight into registers. The columns
//   left of the MB are the ones this CTA has just filtered: shared memory
//   holds the row of MBs as a ring of columns (64 luma, 32 chroma), so
//   they stay where they are and nothing is copied. Each lane filters one
//   line (16 luma lines; 8 of U and 8 of V) through all of its edges in
//   registers, so the only sync between edges is the one between the
//   vertical and the horizontal pass; each lane then stores its line
//   straight to device memory.
// - the bytes: every pixel is loaded about once per window that holds
//   it and each parameter row once; against the chain they cost little.
#include <atomic>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace {

using rows::publish;
using rows::wait_row;

// packed parameter row offsets (int32 lanes)
constexpr int OFF_BSV = 0;      // [4,16]
constexpr int OFF_BSH = 64;
constexpr int OFF_TCV = 128;
constexpr int OFF_TCH = 192;
constexpr int OFF_AV = 256;     // [4]
constexpr int OFF_BV = 260;
constexpr int OFF_AH = 264;
constexpr int OFF_BH = 268;
constexpr int OFF_BSCV = 272;   // [2,8]
constexpr int OFF_BSCH = 288;
constexpr int OFF_TCCV = 304;
constexpr int OFF_TCCH = 320;
constexpr int OFF_ACV = 336;    // [2]
constexpr int OFF_BCV = 338;
constexpr int OFF_ACH = 340;
constexpr int OFF_BCH = 342;
constexpr int PW = 384;
constexpr int NTHREADS = 32;   // one warp

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// One luma line across an edge, p0/q0 nearest to it; filters p0..p2,
// q0..q2 in place (same math as ops/deblock.filter_luma).
__device__ __forceinline__ void luma_line(int p3, int& p2, int& p1, int& p0,
                                          int& q0, int& q1, int& q2, int q3,
                                          int bs, int alpha, int beta,
                                          int tc0) {
  const bool filt = bs > 0 && iabs(p0 - q0) < alpha &&
                    iabs(p1 - p0) < beta && iabs(q1 - q0) < beta;
  if (!filt) return;
  const int ap = iabs(p2 - p0), aq = iabs(q2 - q0);
  int np0 = p0, np1 = p1, np2 = p2, nq0 = q0, nq1 = q1, nq2 = q2;
  if (bs < 4) {
    const int tc = tc0 + (ap < beta) + (aq < beta);
    const int delta = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
    np0 = clampi(p0 + delta, 0, 255);
    nq0 = clampi(q0 - delta, 0, 255);
    if (ap < beta)
      np1 = p1 + clampi((p2 + ((p0 + q0 + 1) >> 1) - (p1 * 2)) >> 1, -tc0, tc0);
    if (aq < beta)
      nq1 = q1 + clampi((q2 + ((p0 + q0 + 1) >> 1) - (q1 * 2)) >> 1, -tc0, tc0);
  } else if (bs == 4) {
    const bool cond = iabs(p0 - q0) < ((alpha >> 2) + 2);
    if (cond && ap < beta) {
      np0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      np1 = (p2 + p1 + p0 + q0 + 2) >> 2;
      np2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      np0 = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (cond && aq < beta) {
      nq0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      nq1 = (q2 + q1 + q0 + p0 + 2) >> 2;
      nq2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      nq0 = (2 * q1 + q0 + p1 + 2) >> 2;
    }
  }
  p0 = np0; p1 = np1; p2 = np2;
  q0 = nq0; q1 = nq1; q2 = nq2;
}

// One chroma line across an edge; filters p0, q0 in place
// (ops/deblock.filter_chroma).
__device__ __forceinline__ void chroma_line(int p1, int& p0, int& q0, int q1,
                                            int bs, int alpha, int beta,
                                            int tc0) {
  const bool filt = bs > 0 && iabs(p0 - q0) < alpha &&
                    iabs(p1 - p0) < beta && iabs(q1 - q0) < beta;
  if (!filt) return;
  if (bs < 4) {
    const int tc = tc0 + 1;
    const int delta = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
    const int np0 = clampi(p0 + delta, 0, 255);
    q0 = clampi(q0 - delta, 0, 255);
    p0 = np0;
  } else if (bs == 4) {
    const int np0 = (2 * p1 + p0 + q1 + 2) >> 2;
    q0 = (2 * q1 + q0 + p1 + 2) >> 2;
    p0 = np0;
  }
}

// A luma line of window samples 4..23 across the MB (v[i] = sample
// 4+i): its 4 edges, edge k between samples 7+4k and 8+4k. `bs`/`tc`
// point at the line's lane of edge 0 in a [4, 16] parameter block.
__device__ __forceinline__ void luma_edges(int (&v)[20], const int* bs,
                                           const int* tc, const int* al,
                                           const int* be) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    luma_line(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3],
              v[4 * k + 4], v[4 * k + 5], v[4 * k + 6], v[4 * k + 7],
              bs[16 * k], al[k], be[k], tc[16 * k]);
}

// A chroma line of window samples 6..13 (v[i] = sample 6+i): its 2
// edges, edge j between samples 7+4j and 8+4j; [2, 8] parameter block.
template <int N>
__device__ __forceinline__ void chroma_edges(int (&v)[N], const int* bs,
                                             const int* tc, const int* al,
                                             const int* be) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    chroma_line(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3],
                bs[8 * j], al[j], be[j], tc[8 * j]);
}

// One warp walks one MB row of one plane kind. Window coordinates: MB
// (r, x)'s luma window row i, column j is plane element (16r + i,
// 16x + j), the MB itself rows and columns 8..23 (chroma: 8r, 8x and
// 8..15). Shared memory holds the plane's MB rows (window rows 8..23 /
// 8..15) as a ring of columns: window column j of MB x sits at ring
// column (16x + j) & 63 ((8x + j) & 31), so MB x+1's columns 0..7 are
// MB x's columns 16..23. Rows are 16-byte aligned for cp.async.
constexpr int LRS = 68;     // luma ring row: 64 columns
constexpr int CRS = 36;     // chroma ring row: 32 columns
constexpr int LPW = 272;    // luma lanes of a parameter row
constexpr int CPW = 72;     // chroma lanes (from OFF_BSCV on)

struct Smem {
  __align__(16) int prm[2][LPW];   // MB x's parameters in prm[x & 1]
  __align__(16) int y[16][LRS];
  __align__(16) int c[2][8][CRS];
};

__device__ void luma_row(Smem& sm, int* Y, int ys, const int* P,
                         int* prog, int r, int mb_w, int lane) {
  int* const yrow = Y + (size_t)(16 * r) * ys;
  const int t = lane;  // lanes 0-15: one line each
  // the interior (window rows and columns 8..23) and the parameter row
  // of MB x, 16 bytes at a time
  auto prefetch = [&](int x) {
    int* const win = yrow + 16 * x;
    for (int i = lane; i < 16 * 4; i += 32) {
      const int row = i / 4, col = 8 + 4 * (i % 4);
      __pipeline_memcpy_async(&sm.y[row][(16 * x + col) & 63],
                              win + (size_t)(8 + row) * ys + col, 16);
    }
    const int* const src = P + (size_t)(r * mb_w + x) * PW;
    for (int i = lane; i < LPW / 4; i += 32)
      __pipeline_memcpy_async(&sm.prm[x & 1][4 * i], src + 4 * i, 16);
  };
  // MB 0's left columns 4..7 are the plane's padding
  if (lane < 16)
    __pipeline_memcpy_async(&sm.y[lane][4], yrow + (size_t)(8 + lane) * ys + 4,
                            16);
  prefetch(0);
  __pipeline_commit();
  int seen = 0;
  for (int x = 0; x < mb_w; ++x) {
    __pipeline_wait_prior(0);
    __syncwarp();
    if (x + 1 < mb_w) {
      prefetch(x + 1);
      __pipeline_commit();
    }
    const int* const pr = sm.prm[x & 1];
    const int by = (16 * x) & 63;
    int* const win = yrow + 16 * x;
    // (1) vertical edges, one window row per lane: they touch only this
    // MB row, so they run before the wait
    if (t < 16) {
      int v[20];
      int* const s = sm.y[t];
#pragma unroll
      for (int i = 0; i < 20; ++i) v[i] = s[(by + 4 + i) & 63];
      luma_edges(v, pr + OFF_BSV + t, pr + OFF_TCV + t, pr + OFF_AV,
                 pr + OFF_BV);
#pragma unroll
      for (int i = 1; i < 19; ++i) s[(by + 4 + i) & 63] = v[i];
      // columns 5..7 (the left MB's pixels) are final now
#pragma unroll
      for (int i = 1; i < 4; ++i) win[(size_t)(8 + t) * ys + 4 + i] = v[i];
    }
    __syncwarp();
    // (2) wait until row r-1 has finished MBs 0..min(x+1, mb_w-1)
    if (r > 0) wait_row(prog - 1, min(x + 2, mb_w), seen, lane);
    // (3) horizontal edges, one window column per lane; the 4 rows above
    // the MB come through L2. Each lane stores its column to the ring
    // (the next MB's left columns) and to the plane
    if (t < 16) {
      const int col = 8 + t, rc = (by + col) & 63;
      int v[20];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __ldcg(win + (size_t)(4 + i) * ys + col);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[4 + i] = sm.y[i][rc];
      luma_edges(v, pr + OFF_BSH + t, pr + OFF_TCH + t, pr + OFF_AH,
                 pr + OFF_BH);
#pragma unroll
      for (int i = 4; i < 19; ++i) sm.y[i - 4][rc] = v[i];
#pragma unroll
      for (int i = 1; i < 20; ++i) win[(size_t)(4 + i) * ys + col] = v[i];
    }
    publish(prog, x + 1, lane);
  }
}

__device__ void chroma_row(Smem& sm, int* U, int* V, int cs, const int* P,
                           int* prog, int r, int mb_w, int lane) {
  int* const urow = U + (size_t)(8 * r) * cs;
  int* const vrow = V + (size_t)(8 * r) * cs;
  const int pl = (lane >> 3) & 1, t = lane & 7;   // lanes 0-7 U, 8-15 V
  int* const prow = pl ? vrow : urow;
  auto prefetch = [&](int x) {
    // 2 planes x 8 rows x 2 chunks of 4, one per lane
    const int p = lane / 16, row = (lane / 2) % 8, col = 8 + 4 * (lane % 2);
    __pipeline_memcpy_async(&sm.c[p][row][(8 * x + col) & 31],
                            (p ? vrow : urow) + 8 * x +
                                (size_t)(8 + row) * cs + col,
                            16);
    const int* const src = P + (size_t)(r * mb_w + x) * PW + OFF_BSCV;
    if (lane < CPW / 4)
      __pipeline_memcpy_async(&sm.prm[x & 1][4 * lane], src + 4 * lane, 16);
  };
  // MB 0's left columns 4..7 are the plane's padding
  if (lane < 16)
    __pipeline_memcpy_async(&sm.c[lane / 8][lane % 8][4],
                            (lane / 8 ? vrow : urow) +
                                (size_t)(8 + lane % 8) * cs + 4,
                            16);
  prefetch(0);
  __pipeline_commit();
  int seen = 0;
  for (int x = 0; x < mb_w; ++x) {
    __pipeline_wait_prior(0);
    __syncwarp();
    if (x + 1 < mb_w) {
      prefetch(x + 1);
      __pipeline_commit();
    }
    // prm holds the chroma part of the parameter row (from OFF_BSCV on)
    const int* const pr = sm.prm[x & 1];
    auto at = [pr](int off) { return pr + (off - OFF_BSCV); };
    const int bc = (8 * x) & 31;
    int* const win = prow + 8 * x;
    // (1) vertical edges, one window row per lane, before the wait
    if (lane < 16) {
      int v[8];
      int* const s = sm.c[pl][t];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = s[(bc + 6 + i) & 31];
      chroma_edges(v, at(OFF_BSCV) + t, at(OFF_TCCV) + t, at(OFF_ACV),
                   at(OFF_BCV));
#pragma unroll
      for (int i = 1; i < 7; ++i) s[(bc + 6 + i) & 31] = v[i];
      win[(size_t)(8 + t) * cs + 7] = v[1];
    }
    __syncwarp();
    // (2) wait until row r-1 has finished MBs 0..min(x+1, mb_w-1)
    if (r > 0) wait_row(prog - 1, min(x + 2, mb_w), seen, lane);
    // (3) horizontal edges, one window column per lane
    if (lane < 16) {
      const int col = 8 + t, rc = (bc + col) & 31;
      int v[10];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v[i] = __ldcg(win + (size_t)(6 + i) * cs + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[2 + i] = sm.c[pl][i][rc];
      chroma_edges(v, at(OFF_BSCH) + t, at(OFF_TCCH) + t, at(OFF_ACH),
                   at(OFF_BCH));
#pragma unroll
      for (int i = 2; i < 7; ++i) sm.c[pl][i - 2][rc] = v[i];
#pragma unroll
      for (int i = 1; i < 10; ++i) win[(size_t)(6 + i) * cs + col] = v[i];
    }
    publish(prog, x + 1, lane);
  }
}

// sync[0]: the next work item; item i is MB row i / 2 of luma (i even)
// or of chroma (i odd). sync[1 + r] / sync[1 + mb_h + r]: MBs of luma /
// chroma row r finished. Items are claimed in order, and a row waits
// only on the row above of its own plane kind, claimed two items
// earlier.
__global__ void __launch_bounds__(NTHREADS)
deblock_rows_kernel(int* __restrict__ Y, int* __restrict__ U,
                    int* __restrict__ V, int ys, int cs,
                    const int* __restrict__ P, int* __restrict__ sync,
                    int mb_w, int mb_h) {
  __shared__ Smem sm;
  const int lane = threadIdx.x;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(sync, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= 2 * mb_h) return;
    const int r = item >> 1;
    if (item & 1)
      chroma_row(sm, U, V, cs, P, sync + 1 + mb_h + r, r, mb_w, lane);
    else
      luma_row(sm, Y, ys, P, sync + 1 + r, r, mb_w, lane);
    __syncwarp();
  }
}

std::atomic<int> resident[rows::MAX_DEVICES];   // 0: not asked yet

}  // namespace

// Y/U/V: int32 working planes (row strides ys, cs elements), filtered in
// place; rows 16-byte aligned (ys, cs multiples of 4). P: [mb_w*mb_h,
// 384] packed params, 16-byte aligned. sync: device scratch of
// 1 + 2*mb_h int32, zeroed here on `stream` before the launch. Launches
// one kernel of min(2*mb_h, SMs x resident CTAs per SM) one-warp CTAs on
// `stream`.
extern "C" int pip_deblock_frame(void* Y, void* U, void* V, int ys, int cs,
                                 const void* P, void* sync, int mb_w,
                                 int mb_h, void* stream) {
  return rows::launch_rows(deblock_rows_kernel, resident, NTHREADS, 2 * mb_h,
                           sync, (size_t)(1 + 2 * mb_h),
                           (cudaStream_t)stream, (int*)Y, (int*)U, (int*)V,
                           ys, cs, (const int*)P, (int*)sync, mb_w, mb_h);
}
