// K3: the decoder's intra reconstruction (spec 8.3) of every intra MB of
// B frames, as one persistent launch that walks the MB rows.
//
// Replaces the decoder's compiled intra wavefronts, jax.lax.scan inside a
// jit: _intra_scan (losslessh264_tpu/decoder_jax.py:420-592, the scan at
// :564), _intra_scan_sparse (:594-655, the scan at :653) and the vmapped
// scan of recon_intra_batch (:702-742, :737). Plain torch versions:
// losslessh264_tpu_torch/decoder_torch.py _intra_scan_plain and
// _intra_scan_sparse_plain; wrapper ops/intra.intra_recon.
//
// Layout: int32 working planes [B, H+16, W+16] (luma) and
// [B, H/2+16, W/2+16] (chroma), padded by WPAD = 8 zeros on every side
// and filled with the inter recon (0 at intra MBs); the residuals
// res_y [B, n, 16, 16], res_u / res_v [B, n, 8, 8]; one int32 row of
// INFO_W per MB: class, avail L/T/TL/TR, transform8, i16 mode, chroma
// mode, the 16 I4x4 modes (raster). The constant tables come from the
// wrapper (ops/intra.K3_TABLES): the 4x4 decode order, the top-right
// kind of each 4x4 block (decoder_torch._I4_TR_KIND), and the
// directional-mode tables of ops/intra (_TAB4, _TAB8): every sample of a
// directional 4x4 / 8x8 mode is (w0*e[i0] + w1*e[i1] + w2*e[i2] + rnd)
// >> sh over the block's edge vector e = [left..., top-left, top...].
//
// What bounds it on the H100:
// - dependencies: MB (y, x) predicts from its left, above-left, above and
//   above-right neighbours, so a frame is a chain of 2*(mb_h-1)+mb_w
//   dependent MB steps (168 at 720p), and inside an I4x4 MB 16 dependent
//   4x4 blocks. Each step is a hand-off between SMs (a flag, the row
//   above read from L2). That chain bounds the kernel, not the bytes.
// - bytes: the picture read and written once (int32, 11.06 MB at 720p),
//   the residuals read once (5.53 MB) and the MB rows (0.35 MB): ~17 MB,
//   ~5 us at 3.35 TB/s.
// What the design does about each (K2's schedule, csrc/wavefront.cuh):
// - one launch for all B frames and no host schedule. A CTA is one warp;
//   it claims the next work item, one MB row of one frame (frame-major),
//   from a device counter and walks it left to right. Before an intra MB
//   (y, x), lane 0 waits with ld.acquire.gpu until row y-1 of its frame
//   has published progress >= min(x+2, mb_w); after the MB the warp
//   publishes x+1 (__threadfence, then st.release.gpu). A non-intra MB
//   only publishes. Items are claimed in order by running CTAs, so a CTA
//   waits only on a row that a running CTA holds: no deadlock, no
//   cooperative launch. Raster order with that wait is a valid order of
//   the wavefront's dependency graph.
// - only the coded mode is predicted (the plain version computes all of
//   them and selects), each lane one or two samples; the 17x25 luma and
//   9x9 chroma contexts are staged in shared memory through L2 (__ldcg)
//   and the I4x4 / I8x8 blocks reconstruct in place there.
#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_common.cuh"

namespace {

using namespace intra;

constexpr int INFO_W = 24;
// the packed constant tables (ops/intra.K3_TABLES): BLK_ORDER [16],
// _I4_TR_KIND [16], _TAB4 [9, 16, 8], _TAB8 [9, 64, 8]
constexpr int T_BLK = 0;
constexpr int T_TRK = 16;
constexpr int T_TAB4 = 32;
constexpr int T_TAB8 = T_TAB4 + 9 * 16 * 8;
constexpr int T_LEN = T_TAB8 + 9 * 64 * 8;

struct Smem {
  int tab[T_LEN];
  int ctx[17][25];     // row 0: above (col 0 the above-left), col 0: left
  int cu[9][9];
  int cv[9][9];
  int raw[25];         // an I8x8 block's unfiltered edge
  int edge[25];        // the current block's edge vector
};

// I16x16 (mode 0 V, 1 H, 2 DC, 3 plane) of every sample, plus the
// residual, straight to the plane
__device__ void recon_i16(Smem& sm, int mode, bool aL, bool aT,
                          const int* res, int* dst, int ws, int lane) {
  int lsum = 0, tsum = 0;
  for (int i = 0; i < 16; ++i) {
    lsum += sm.ctx[1 + i][0];
    tsum += sm.ctx[0][1 + i];
  }
  const int dc = dc_value(lsum, tsum, aL, aT, 4);
  for (int p = lane; p < 256; p += NTHREADS) {
    const int y = p >> 4, x = p & 15;
    int pred;
    if (mode == 0) pred = sm.ctx[0][1 + x];
    else if (mode == 1) pred = sm.ctx[1 + y][0];
    else if (mode == 2) pred = dc;
    else pred = plane_sample(&sm.ctx[1][0], 25, &sm.ctx[0][1], sm.ctx[0][0],
                             16, x, y);
    dst[(size_t)y * ws + x] = clamp255(pred + res[p]);
  }
}

// I4x4: the 16 blocks in decode order, reconstructed in sm.ctx
__device__ void recon_i4(Smem& sm, const int* i4, bool aL, bool aT,
                         bool aTR, const int* res, int lane) {
  for (int d = 0; d < 16; ++d) {
    const int r = sm.tab[T_BLK + d];
    const int by = r >> 2, bx = r & 3;
    const int ly = 1 + 4 * by, lx = 1 + 4 * bx;
    const int kind = sm.tab[T_TRK + r];
    const bool trv = kind == 1 || (kind == 2 && aT) || (kind == 3 && aTR);
    // e = [l0..l3, tl, t0..t7]; an unavailable top-right repeats t3
    if (lane < 4) sm.edge[lane] = sm.ctx[ly + lane][lx - 1];
    else if (lane == 4) sm.edge[4] = sm.ctx[ly - 1][lx - 1];
    else if (lane < 13)
      sm.edge[lane] = sm.ctx[ly - 1][lx + ((lane - 5 < 4 || trv) ? lane - 5
                                                                 : 3)];
    __syncwarp();
    if (lane < 16) {
      const int mode = clampi(i4[r], 0, 8);
      const int y = lane >> 2, x = lane & 3;
      int pred;
      if (mode == 2) {
        const int* e = sm.edge;
        pred = dc_value(e[0] + e[1] + e[2] + e[3], e[5] + e[6] + e[7] + e[8],
                        bx == 0 ? aL : true, by == 0 ? aT : true, 2);
      } else {
        pred = table_sample(&sm.tab[T_TAB4 + (mode * 16 + lane) * 8],
                            sm.edge);
      }
      sm.ctx[ly + y][lx + x] =
          clamp255(pred + res[(4 * by + y) * 16 + 4 * bx + x]);
    }
    __syncwarp();
  }
}

// I8x8: the 4 blocks with the reference-sample filter (8.3.2.2.1,
// ops/intra.pred8_all), reconstructed in sm.ctx
__device__ void recon_i8(Smem& sm, const int* i4, bool aL, bool aT,
                         bool aTL, bool aTR, const int* res, int lane) {
  for (int b8 = 0; b8 < 4; ++b8) {
    const int by = b8 >> 1, bx = b8 & 1;
    const int ly = 1 + 8 * by, lx = 1 + 8 * bx;
    // (top-right available, top-left available) per block, as
    // decoder_torch._recon_mb_luma's table
    const bool trv = b8 == 0 ? aT : b8 == 1 ? aTR : b8 == 2;
    const bool tla = b8 == 0 ? aTL : b8 == 1 ? aT : b8 == 2 ? aL : true;
    const bool bL = bx == 0 ? aL : true, bT = by == 0 ? aT : true;
    // raw = [l0..l7, tl, t0..t15]; an unavailable top-right repeats t7
    if (lane < 8) sm.raw[lane] = sm.ctx[ly + lane][lx - 1];
    else if (lane == 8) sm.raw[8] = sm.ctx[ly - 1][lx - 1];
    else if (lane < 25)
      sm.raw[lane] = sm.ctx[ly - 1][lx + ((lane - 9 < 8 || trv) ? lane - 9
                                                                : 7)];
    __syncwarp();
    if (lane < 25) {
      const int* l = sm.raw;
      const int tl = sm.raw[8];
      const int* t = sm.raw + 9;
      int v;
      if (lane == 0) {
        v = tla ? (tl + 2 * l[0] + l[1] + 2) >> 2 : (3 * l[0] + l[1] + 2) >> 2;
      } else if (lane < 7) {
        v = (l[lane - 1] + 2 * l[lane] + l[lane + 1] + 2) >> 2;
      } else if (lane == 7) {
        v = (l[6] + 3 * l[7] + 2) >> 2;
      } else if (lane == 8) {
        v = tl;
        if (tla) {
          if (bL && bT) v = (l[0] + 2 * tl + t[0] + 2) >> 2;
          else if (bT) v = (3 * tl + t[0] + 2) >> 2;
          else if (bL) v = (3 * tl + l[0] + 2) >> 2;
        }
      } else {
        const int i = lane - 9;
        if (i == 0)
          v = tla ? (tl + 2 * t[0] + t[1] + 2) >> 2
                  : (3 * t[0] + t[1] + 2) >> 2;
        else if (i < 15)
          v = (t[i - 1] + 2 * t[i] + t[i + 1] + 2) >> 2;
        else
          v = (t[14] + 3 * t[15] + 2) >> 2;
      }
      sm.edge[lane] = v;
    }
    __syncwarp();
    const int mode = clampi(i4[(b8 >> 1) * 8 + (b8 & 1) * 2], 0, 8);
    int dc = 0;
    if (mode == 2) {
      int ls = 0, ts = 0;
      for (int i = 0; i < 8; ++i) {
        ls += sm.edge[i];
        ts += sm.edge[9 + i];
      }
      dc = dc_value(ls, ts, bL, bT, 3);
    }
    for (int p = lane; p < 64; p += NTHREADS) {
      const int y = p >> 3, x = p & 7;
      const int pred =
          mode == 2 ? dc
                    : table_sample(&sm.tab[T_TAB8 + (mode * 64 + p) * 8],
                                   sm.edge);
      sm.ctx[ly + y][lx + x] =
          clamp255(pred + res[(8 * by + y) * 16 + 8 * bx + x]);
    }
    __syncwarp();
  }
}

// sync[0]: the next work item; item i is MB row i % mb_h of frame
// i / mb_h; sync[1 + i]: MBs of that row finished.
__global__ void __launch_bounds__(NTHREADS)
intra_dec_kernel(int* __restrict__ Y, int* __restrict__ U,
                 int* __restrict__ V, const int* __restrict__ res_y,
                 const int* __restrict__ res_u, const int* __restrict__ res_v,
                 const int* __restrict__ info, const int* __restrict__ tables,
                 int* __restrict__ sync, int mb_w, int mb_h, int B) {
  __shared__ Smem sm;
  const int lane = threadIdx.x;
  for (int i = lane; i < T_LEN; i += NTHREADS) sm.tab[i] = tables[i];
  __syncwarp();
  const int n = mb_w * mb_h;
  const int ws = mb_w * 16 + 2 * WPAD, hs = mb_h * 16 + 2 * WPAD;
  const int cws = mb_w * 8 + 2 * WPAD, chs = mb_h * 8 + 2 * WPAD;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(sync, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= B * mb_h) return;
    const int f = item / mb_h, r = item % mb_h;
    int* const prog = sync + 1 + item;
    int* const Yf = Y + (size_t)f * hs * ws;
    int* const Uf = U + (size_t)f * chs * cws;
    int* const Vf = V + (size_t)f * chs * cws;
    int seen = 0;
    for (int x = 0; x < mb_w; ++x) {
      const int mb = f * n + r * mb_w + x;
      const int* const inf = info + (size_t)mb * INFO_W;
      const int cls = __ldg(inf);
      if (cls != 0 && cls != 1 && cls != 2) {
        publish(prog, x + 1, lane);
        continue;
      }
      const bool aL = __ldg(inf + 1), aT = __ldg(inf + 2);
      const bool aTL = __ldg(inf + 3), aTR = __ldg(inf + 4);
      const int t8 = __ldg(inf + 5);
      if (r > 0) wait_row(prog - 1, min(x + 2, mb_w), seen, lane);
      // the contexts from the planes (through L2: other SMs wrote the
      // rows above)
      const int y0 = 16 * r + WPAD, x0 = 16 * x + WPAD;
      const int cy = 8 * r + WPAD, cx = 8 * x + WPAD;
      for (int i = lane; i < 17 * 25; i += NTHREADS)
        sm.ctx[i / 25][i % 25] =
            __ldcg(Yf + (size_t)(y0 - 1 + i / 25) * ws + x0 - 1 + i % 25);
      for (int i = lane; i < 81; i += NTHREADS) {
        const size_t o = (size_t)(cy - 1 + i / 9) * cws + cx - 1 + i % 9;
        sm.cu[i / 9][i % 9] = __ldcg(Uf + o);
        sm.cv[i / 9][i % 9] = __ldcg(Vf + o);
      }
      __syncwarp();
      const int* const ry = res_y + (size_t)mb * 256;
      int* const dst = Yf + (size_t)y0 * ws + x0;
      if (cls == 1) {
        recon_i16(sm, clampi(__ldg(inf + 6), 0, 3), aL, aT, ry, dst, ws,
                  lane);
      } else {
        if (cls == 2 || t8 != 0)
          recon_i8(sm, inf + 8, aL, aT, aTL, aTR, ry, lane);
        else
          recon_i4(sm, inf + 8, aL, aT, aTR, ry, lane);
        for (int p = lane; p < 256; p += NTHREADS)
          dst[(size_t)(p >> 4) * ws + (p & 15)] =
              sm.ctx[1 + (p >> 4)][1 + (p & 15)];
      }
      const int cm = clampi(__ldg(inf + 7), 0, 3);
      for (int q = lane; q < 128; q += NTHREADS) {
        const int p = q & 63;
        const bool v = q >= 64;
        const int pred = chroma_pred(v ? sm.cv : sm.cu, cm, aL, aT, p);
        const int rv = (v ? res_v : res_u)[(size_t)mb * 64 + p];
        (v ? Vf : Uf)[(size_t)(cy + (p >> 3)) * cws + cx + (p & 7)] =
            clamp255(pred + rv);
      }
      publish(prog, x + 1, lane);
    }
    __syncwarp();
  }
}

std::atomic<int> resident[rows::MAX_DEVICES];   // 0: not asked yet

}  // namespace

// Y/U/V: the B frames' int32 working planes, reconstructed in place;
// res_*: int32 residuals; info: [B*n, 24] int32 MB rows; tables: the
// packed constant tables; sync: device scratch of 1 + B*mb_h int32,
// zeroed here on `stream` before the launch. All contiguous.
extern "C" int pip_intra_dec(void* Y, void* U, void* V, const void* res_y,
                             const void* res_u, const void* res_v,
                             const void* info, const void* tables, void* sync,
                             int mb_w, int mb_h, int B, void* stream) {
  return rows::launch_rows(
      intra_dec_kernel, resident, NTHREADS, B * mb_h, sync,
      (size_t)(1 + B * mb_h), (cudaStream_t)stream, (int*)Y, (int*)U,
      (int*)V, (const int*)res_y, (const int*)res_u, (const int*)res_v,
      (const int*)info, (const int*)tables, (int*)sync, mb_w, mb_h, B);
}
