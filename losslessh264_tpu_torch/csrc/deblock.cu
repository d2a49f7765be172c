// K2: the H.264 in-loop deblocking filter (spec 8.7) over a whole frame,
// as a wavefront over the slope-2 MB diagonals (2*mb_y + mb_x = d).
//
// Replaces the Pallas kernel deblock_wavefront / _kernel
// (losslessh264_tpu/ops/deblock_pallas.py:57-258). Plain torch version:
// losslessh264_tpu_torch/ops/deblock.py deblock_wavefront_plain.
//
// Layout: int32 working planes padded by WPAD = 8 on every side (luma
// [H+16, W+16], chroma [H/2+16, W/2+16]), so MB (my, mx)'s 24x24 luma
// window starts at plane row 16*my, column 16*mx, and its 16x16 chroma
// windows at 8*my, 8*mx. Per-MB filter parameters (bS, alpha, beta,
// tc0 per edge) come packed in one [n, 384] int32 row per MB, the
// layout of the TPU kernel's _pack_params (offsets below).
//
// What bounds it on the H100: latency, not bytes or operations. A 720p
// frame is 168 diagonals of at most 40 MBs; each MB moves ~4.4 KB and
// runs 8 luma + 2x4 chroma edge steps that must stay in order (later
// edges read filtered samples, 8.7). The card has 132 SMs, so one
// diagonal fills at most a third of it, and the diagonals run one after
// another: the frame costs ~168 dependent launches.
// Design: one launch per diagonal from a host loop (so the stream
// orders the diagonals), one CTA per MB of the diagonal. Windows of one
// diagonal are disjoint (consecutive members are 2 MBs apart across
// and 1 up), so CTAs of a launch need no synchronisation. A CTA stages
// its luma and chroma windows and parameter row in shared memory, runs
// the edges with one thread per line of an edge (16 luma threads, 8
// per chroma plane; luma and chroma planes are independent, so they
// step together) and a __syncthreads() between edges, then writes the
// windows back. A persistent single launch (grid sync or per-row
// progress flags) would remove the launch chain; that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr int NTHREADS = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// One luma line across an edge: p[0..3] / q[0..3] nearest first.
// Writes back p0..p2, q0..q2 (same math as ops/deblock.filter_luma).
__device__ void filter_luma_line(int* pp[4], int* qq[4], int bs, int alpha,
                                 int beta, int tc0) {
  const int p0 = *pp[0], p1 = *pp[1], p2 = *pp[2], p3 = *pp[3];
  const int q0 = *qq[0], q1 = *qq[1], q2 = *qq[2], q3 = *qq[3];
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
  *pp[0] = np0; *pp[1] = np1; *pp[2] = np2;
  *qq[0] = nq0; *qq[1] = nq1; *qq[2] = nq2;
}

// One chroma line across an edge (ops/deblock.filter_chroma).
__device__ void filter_chroma_line(int* pp0, int* pp1, int* qq0, int* qq1,
                                   int bs, int alpha, int beta, int tc0) {
  const int p0 = *pp0, p1 = *pp1, q0 = *qq0, q1 = *qq1;
  const bool filt = bs > 0 && iabs(p0 - q0) < alpha &&
                    iabs(p1 - p0) < beta && iabs(q1 - q0) < beta;
  if (!filt) return;
  if (bs < 4) {
    const int tc = tc0 + 1;
    const int delta = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
    *pp0 = clampi(p0 + delta, 0, 255);
    *qq0 = clampi(q0 - delta, 0, 255);
  } else if (bs == 4) {
    *pp0 = (2 * p1 + p0 + q1 + 2) >> 2;
    *qq0 = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

__global__ void __launch_bounds__(NTHREADS)
deblock_diag_kernel(int* __restrict__ Y, int* __restrict__ U,
                    int* __restrict__ V, int ys, int cs,
                    const int* __restrict__ P, const int* __restrict__ mbs,
                    int mb_w) {
  __shared__ int sy[24][24];
  __shared__ int sc[2][16][16];
  __shared__ int prm[PW];
  const int mb = mbs[blockIdx.x];
  const int my = mb / mb_w, mx = mb % mb_w;
  const int tid = threadIdx.x;
  int* const luma = Y + (size_t)(16 * my) * ys + 16 * mx;
  int* const cu = U + (size_t)(8 * my) * cs + 8 * mx;
  int* const cv = V + (size_t)(8 * my) * cs + 8 * mx;

  for (int i = tid; i < PW; i += NTHREADS) prm[i] = P[(size_t)mb * PW + i];
  for (int i = tid; i < 24 * 24; i += NTHREADS)
    sy[i / 24][i % 24] = luma[(size_t)(i / 24) * ys + i % 24];
  for (int i = tid; i < 16 * 16; i += NTHREADS) {
    sc[0][i / 16][i % 16] = cu[(size_t)(i / 16) * cs + i % 16];
    sc[1][i / 16][i % 16] = cv[(size_t)(i / 16) * cs + i % 16];
  }
  __syncthreads();

  // edge steps: luma 4 vertical then 4 horizontal (threads 0-15, one
  // line each); each chroma plane 2 vertical then 2 horizontal (threads
  // 16-23 U, 24-31 V) alongside the first four luma steps
  for (int s = 0; s < 8; ++s) {
    if (tid < 16) {
      const int t = tid;
      int* pp[4];
      int* qq[4];
      int bs, al, be, tc0;
      if (s < 4) {
        const int ex = 8 + 4 * s, row = 8 + t;
        for (int i = 0; i < 4; ++i) {
          pp[i] = &sy[row][ex - 1 - i];
          qq[i] = &sy[row][ex + i];
        }
        bs = prm[OFF_BSV + s * 16 + t];
        tc0 = prm[OFF_TCV + s * 16 + t];
        al = prm[OFF_AV + s];
        be = prm[OFF_BV + s];
      } else {
        const int k = s - 4, ey = 8 + 4 * k, col = 8 + t;
        for (int i = 0; i < 4; ++i) {
          pp[i] = &sy[ey - 1 - i][col];
          qq[i] = &sy[ey + i][col];
        }
        bs = prm[OFF_BSH + k * 16 + t];
        tc0 = prm[OFF_TCH + k * 16 + t];
        al = prm[OFF_AH + k];
        be = prm[OFF_BH + k];
      }
      filter_luma_line(pp, qq, bs, al, be, tc0);
    } else if (tid < 32 && s < 4) {
      const int c = (tid - 16) / 8, t = (tid - 16) % 8;
      int (*w)[16] = sc[c];
      if (s < 2) {
        const int ex = 8 + 4 * s, row = 8 + t;
        filter_chroma_line(&w[row][ex - 1], &w[row][ex - 2], &w[row][ex],
                           &w[row][ex + 1], prm[OFF_BSCV + s * 8 + t],
                           prm[OFF_ACV + s], prm[OFF_BCV + s],
                           prm[OFF_TCCV + s * 8 + t]);
      } else {
        const int j = s - 2, ey = 8 + 4 * j, col = 8 + t;
        filter_chroma_line(&w[ey - 1][col], &w[ey - 2][col], &w[ey][col],
                           &w[ey + 1][col], prm[OFF_BSCH + j * 8 + t],
                           prm[OFF_ACH + j], prm[OFF_BCH + j],
                           prm[OFF_TCCH + j * 8 + t]);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < 24 * 24; i += NTHREADS)
    luma[(size_t)(i / 24) * ys + i % 24] = sy[i / 24][i % 24];
  for (int i = tid; i < 16 * 16; i += NTHREADS) {
    cu[(size_t)(i / 16) * cs + i % 16] = sc[0][i / 16][i % 16];
    cv[(size_t)(i / 16) * cs + i % 16] = sc[1][i / 16][i % 16];
  }
}

}  // namespace

// Y/U/V: int32 working planes (row strides ys, cs elements), filtered in
// place. P: [n, 384] packed params. mbs: the live MBs of every diagonal,
// concatenated in diagonal order (device). off: host array of n_diags+1
// offsets into mbs. Launches one kernel per non-empty diagonal on
// `stream`, in order.
extern "C" int pip_deblock_wavefront(void* Y, void* U, void* V, int ys,
                                     int cs, const void* P, const void* mbs,
                                     const int* off, int n_diags, int mb_w,
                                     void* stream) {
  for (int d = 0; d < n_diags; ++d) {
    const int cnt = off[d + 1] - off[d];
    if (cnt <= 0) continue;
    deblock_diag_kernel<<<cnt, NTHREADS, 0, (cudaStream_t)stream>>>(
        (int*)Y, (int*)U, (int*)V, ys, cs, (const int*)P,
        (const int*)mbs + off[d], mb_w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
