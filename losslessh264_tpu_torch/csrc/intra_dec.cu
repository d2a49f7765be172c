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
//   dependent MB steps (168 at 720p), and inside an I4x4 MB blocks that
//   predict from their neighbours' recon. Each step is a hand-off between
//   SMs (a flag, the row above read from L2) and one MB's latency. That
//   chain bounds the kernel, not the bytes.
// - bytes: the picture read and written once (int32, 11.06 MB at 720p),
//   the residuals read once (5.53 MB) and the MB rows (0.35 MB): ~17 MB,
//   ~5 us at 3.35 TB/s.
// What the design does about each (K2's schedule, csrc/wavefront.cuh):
// - one launch for all B frames and no host schedule. A CTA of 4 warps
//   claims the next work item, one MB row of one frame (frame-major),
//   from a device counter and walks it left to right. Before an intra MB
//   (y, x), one thread waits with ld.acquire.gpu until row y-1 of its
//   frame has published progress >= min(x+2, mb_w); after the MB's
//   stores the CTA publishes x+1 (__syncthreads, __threadfence,
//   st.release.gpu). A non-intra MB only publishes. Items are claimed in
//   order by running CTAs, so a CTA waits only on a row that a running
//   CTA holds: no deadlock, no cooperative launch.
// - only the row above crosses the hand-off: the next intra MB's
//   residuals (1 KB luma, 0.5 KB chroma) and its MB row are staged in
//   shared memory by cp.async one MB ahead, so nothing inside the block
//   loops reads global memory; the left column of an intra left
//   neighbour stays in shared memory from the CTA's own previous MB, that
//   of an inter one is loaded from the plane before the wait; each MB's
//   class is read an MB ahead. After the wait warp 0 reads the 25 + 9 + 9
//   words of the row above. The CTA stores the bottom rows that the row
//   below reads, publishes, and then stores the rest of the MB.
// - warps 0-1 reconstruct luma, warps 2 and 3 the U and V planes, at the
//   same time; I16x16's and chroma's DC and plane parameters are computed
//   once per MB. I4x4 blocks go by the levels of their dependency graph,
//   (by, bx) at level bx + 2 by (the top-right only where _I4_TR_KIND is
//   1): 10 levels of at most 2 blocks, both on warp 0 (16 lanes each; the
//   edge samples by shuffles). I8x8's 4 blocks are a chain (block 2
//   predicts from block 1 as its top-right, block 3 from blocks 1 and 2),
//   64 threads a block.
#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_common.cuh"

namespace {

using namespace intra;

constexpr int INFO_W = 24;
// the packed constant tables (ops/intra.K3_TABLES): BLK_ORDER [16],
// _I4_TR_KIND [16], _TAB4 [9, 16, 8], _TAB8 [9, 64, 8]
constexpr int T_TRK = 16;
constexpr int T_TAB4 = 32;
constexpr int T_TAB8 = T_TAB4 + 9 * 16 * 8;
constexpr int T_LEN = T_TAB8 + 9 * 64 * 8;
constexpr int NTHREADS = 128;   // warps 0-1 luma, 2 U, 3 V
constexpr int BAR_LUMA = 1;     // the luma warps' barrier

struct Smem {
  alignas(16) int res[2][384];      // staged residuals: Y 256, U 64, V 64
  alignas(16) int inf[2][INFO_W];   // staged MB rows
  alignas(16) int tab[T_LEN];
  int ctx[17][25];   // row 0: above (col 0 the above-left), col 0: left;
                     // the MB reconstructs in place
  int cu[9][9];
  int cv[9][9];
  int edge[25];      // the current I8x8 block's filtered edge
  int dc8;           // and its DC
  int claim;
};

// a _TAB4 / _TAB8 row, 8 ints at a 32-byte-aligned offset
__device__ __forceinline__ void load_row(const int* p, int (&row)[8]) {
  const int4 a = *reinterpret_cast<const int4*>(p);
  const int4 b = *reinterpret_cast<const int4*>(p + 4);
  row[0] = a.x; row[1] = a.y; row[2] = a.z; row[3] = a.w;
  row[4] = b.x; row[5] = b.y; row[6] = b.z; row[7] = b.w;
}

// I16x16 (mode 0 V, 1 H, 2 DC, 3 plane) on the 64 luma threads: 4
// samples each, plus the residual, into sm.ctx; the DC sum or the plane's
// parameters only for the mode that needs them
__device__ void recon_i16(Smem& sm, int mode, bool aL, bool aT,
                          const int* res, int t) {
  const int lane = t & 31, i = lane & 15;
  int dc = 0;
  Plane pl{};
  if (mode == 2) {
    const int lt = lane < 16 ? sm.ctx[1 + i][0] | (sm.ctx[0][1 + i] << 16)
                             : 0;
    const int sums = warp_sum(lt);   // low 16 bits the left, high the top
    dc = dc_value(sums & 0xffff, sums >> 16, aL, aT, 4);
  } else if (mode == 3) {
    pl = plane_params(&sm.ctx[1][0], 25, &sm.ctx[0][1], sm.ctx[0][0], 16);
  }
  for (int p = t; p < 256; p += 64) {
    const int y = p >> 4, x = p & 15;
    const int pred = mode == 0   ? sm.ctx[0][1 + x]
                     : mode == 1 ? sm.ctx[1 + y][0]
                     : mode == 2 ? dc
                                 : pl.at(x, y);
    sm.ctx[1 + y][1 + x] = clamp255(pred + res[p]);
  }
}

// the raster index of slot `slot`'s 4x4 block at dependency level L
// (the blocks with bx + 2 by == L, slot 1 one block row below slot 0),
// or slot 0's where the level has no second block
__device__ __forceinline__ int level_blk(int slot, int L) {
  const int by_lo = L > 3 ? (L - 2) >> 1 : 0;
  const int by = by_lo + slot, bx = L - 2 * by;
  return by <= 3 && bx >= 0 ? 4 * by + bx : 4 * by_lo + L - 2 * by_lo;
}

// I4x4 on warp 0: the blocks by dependency level, lanes 0-15 the first
// block of a level, 16-31 the second; reconstructed in sm.ctx. kinds:
// _I4_TR_KIND, 2 bits per raster block. Each level's mode and table row
// are read during the level before.
__device__ void recon_i4(Smem& sm, const int* i4, bool aL, bool aT, bool aTR,
                         const int* res, int lane, int kinds) {
  const int slot = lane >> 4, p = lane & 15, py = p >> 2, px = p & 3;
  int mode = clampi(i4[0], 0, 8), row[8];
  load_row(&sm.tab[T_TAB4 + (mode * 16 + p) * 8], row);
  for (int L = 0; L < 10; ++L) {
    const int r = level_blk(slot, L);
    const bool valid = slot == 0 || r != level_blk(0, L);
    const int by = r >> 2, bx = r & 3;
    const int ly = 1 + 4 * by, lx = 1 + 4 * bx;
    const int kind = (kinds >> (2 * r)) & 3;
    const bool trv = kind == 1 || (kind == 2 && aT) || (kind == 3 && aTR);
    // lane p < 13 holds e[p], e = [l0..l3, tl, t0..t7]; an unavailable
    // top-right repeats t3
    const int j = p - 5;
    const int* const c = &sm.ctx[0][0];
    const int ev = c[p < 4               ? (ly + p) * 25 + lx - 1
                     : p == 4 || p > 12 ? (ly - 1) * 25 + lx - 1
                                        : (ly - 1) * 25 + lx +
                                              (trv || j < 4 ? j : 3)];
    const int rs = res[(4 * by + py) * 16 + 4 * bx + px];
    // the next level's mode and row
    int nmode = 0, nrow[8];
    if (L < 9) {
      nmode = clampi(i4[level_blk(slot, L + 1)], 0, 8);
      load_row(&sm.tab[T_TAB4 + (nmode * 16 + p) * 8], nrow);
    }
    const int e0 = __shfl_sync(FULL, ev, row[0] & 15, 16);
    const int e1 = __shfl_sync(FULL, ev, row[1] & 15, 16);
    const int e2 = __shfl_sync(FULL, ev, row[2] & 15, 16);
    int pred;
    if (mode == 2) {
      int ls = 0, ts = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ls += c[(ly + i) * 25 + lx - 1];
        ts += c[(ly - 1) * 25 + lx + i];
      }
      pred = dc_value(ls, ts, bx > 0 || aL, by > 0 || aT, 2);
    } else {
      pred = table_pred(row, e0, e1, e2);
    }
    if (valid) sm.ctx[ly + py][lx + px] = clamp255(pred + rs);
    __syncwarp();
    mode = nmode;
#pragma unroll
    for (int k = 0; k < 8; ++k) row[k] = nrow[k];
  }
}

// I8x8 on the 64 luma threads: the 4 blocks with the reference-sample
// filter (8.3.2.2.1, ops/intra.pred8_all), reconstructed in sm.ctx
__device__ void recon_i8(Smem& sm, const int* i4, bool aL, bool aT,
                         bool aTL, bool aTR, const int* res, int t) {
  for (int b8 = 0; b8 < 4; ++b8) {
    const int by = b8 >> 1, bx = b8 & 1;
    const int ly = 1 + 8 * by, lx = 1 + 8 * bx;
    const bool bL = bx == 0 ? aL : true, bT = by == 0 ? aT : true;
    const int mode = clampi(i4[(b8 >> 1) * 8 + (b8 & 1) * 2], 0, 8);
    int row[8];
    load_row(&sm.tab[T_TAB8 + (mode * 64 + t) * 8], row);
    if (t < 32) {   // warp 0: the filtered edge and its DC
      // (top-right available, top-left available) per block, as
      // decoder_torch._recon_mb_luma's table
      const bool trv = b8 == 0 ? aT : b8 == 1 ? aTR : b8 == 2;
      const bool tla = b8 == 0 ? aTL : b8 == 1 ? aT : b8 == 2 ? aL : true;
      // raw = [l0..l7, tl, t0..t15] in lanes 0-24; an unavailable
      // top-right repeats t7
      int raw = 0;
      if (t < 8) raw = sm.ctx[ly + t][lx - 1];
      else if (t == 8) raw = sm.ctx[ly - 1][lx - 1];
      else if (t < 25)
        raw = sm.ctx[ly - 1][lx + ((t - 9 < 8 || trv) ? t - 9 : 7)];
      const int prev = __shfl_sync(FULL, raw, t > 0 ? t - 1 : 0);
      const int next = __shfl_sync(FULL, raw, t < 31 ? t + 1 : 31);
      const int l0 = __shfl_sync(FULL, raw, 0);
      const int tl = __shfl_sync(FULL, raw, 8);
      const int t0 = __shfl_sync(FULL, raw, 9);
      int v;
      if (t == 0) {
        v = tla ? (tl + 2 * raw + next + 2) >> 2 : (3 * raw + next + 2) >> 2;
      } else if (t < 7) {
        v = (prev + 2 * raw + next + 2) >> 2;
      } else if (t == 7) {
        v = (prev + 3 * raw + 2) >> 2;
      } else if (t == 8) {
        v = tl;
        if (tla) {
          if (bL && bT) v = (l0 + 2 * tl + t0 + 2) >> 2;
          else if (bT) v = (3 * tl + t0 + 2) >> 2;
          else if (bL) v = (3 * tl + l0 + 2) >> 2;
        }
      } else if (t == 9) {
        v = tla ? (tl + 2 * raw + next + 2) >> 2 : (3 * raw + next + 2) >> 2;
      } else if (t < 24) {
        v = (prev + 2 * raw + next + 2) >> 2;
      } else {
        v = (prev + 3 * raw + 2) >> 2;
      }
      if (t < 25) sm.edge[t] = v;
      if (mode == 2) {
        const int ls = warp_sum(t < 8 ? v : 0);
        const int ts = warp_sum(t >= 9 && t < 17 ? v : 0);
        if (t == 0) sm.dc8 = dc_value(ls, ts, bL, bT, 3);
      }
    }
    group_sync(BAR_LUMA, 64);
    {
      const int y = t >> 3, x = t & 7;
      const int pred = mode == 2 ? sm.dc8
                                 : table_pred(row, sm.edge[row[0]],
                                              sm.edge[row[1]],
                                              sm.edge[row[2]]);
      sm.ctx[ly + y][lx + x] =
          clamp255(pred + res[(8 * by + y) * 16 + 8 * bx + x]);
    }
    group_sync(BAR_LUMA, 64);
  }
}

// one chroma plane on one warp: 2 samples a lane, into its context
__device__ void recon_chroma(int (&c)[9][9], int cm, bool aL, bool aT,
                             const int* res, int lane) {
  const Chroma q = chroma_params(c, aL, aT);
  const int a = chroma_at(c, q, cm, lane), b = chroma_at(c, q, cm, lane + 32);
  __syncwarp();
  c[1 + (lane >> 3)][1 + (lane & 7)] = clamp255(a + res[lane]);
  c[5 + (lane >> 3)][1 + (lane & 7)] = clamp255(b + res[lane + 32]);
}

// cp.async of MB `mb`'s residuals and MB row into buffer `b`: 102 chunks
// of 16 bytes, one per thread of the first 102
__device__ __forceinline__ void stage_mb(Smem& sm, int b, const int* res_y,
                                         const int* res_u, const int* res_v,
                                         const int* info, int mb, int tid) {
  if (tid < 64)
    cp16(&sm.res[b][4 * tid], res_y + (size_t)mb * 256 + 4 * tid);
  else if (tid < 80)
    cp16(&sm.res[b][256 + 4 * (tid - 64)], res_u + (size_t)mb * 64 +
                                               4 * (tid - 64));
  else if (tid < 96)
    cp16(&sm.res[b][320 + 4 * (tid - 80)], res_v + (size_t)mb * 64 +
                                               4 * (tid - 80));
  else if (tid < 102)
    cp16(&sm.inf[b][4 * (tid - 96)], info + (size_t)mb * INFO_W +
                                         4 * (tid - 96));
}

__device__ __forceinline__ bool is_intra(int cls) {
  return cls == 0 || cls == 1 || cls == 2;
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
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < T_LEN; i += NTHREADS) sm.tab[i] = tables[i];
  __syncthreads();
  int kinds = 0;   // _I4_TR_KIND, 2 bits per raster block
  for (int r = 0; r < 16; ++r) kinds |= (sm.tab[T_TRK + r] & 3) << (2 * r);
  const int n = mb_w * mb_h;
  const int ws = mb_w * 16 + 2 * WPAD, hs = mb_h * 16 + 2 * WPAD;
  const int cws = mb_w * 8 + 2 * WPAD, chs = mb_h * 8 + 2 * WPAD;
  for (;;) {
    if (tid == 0) sm.claim = atomicAdd(sync, 1);
    __syncthreads();
    const int item = sm.claim;
    __syncthreads();
    if (item >= B * mb_h) return;
    const int f = item / mb_h, r = item % mb_h;
    int* const prog = sync + 1 + item;
    int* const Yf = Y + (size_t)f * hs * ws;
    int* const Uf = U + (size_t)f * chs * cws;
    int* const Vf = V + (size_t)f * chs * cws;
    int seen = 0;
    int staged = -1;   // the MB whose residuals are in flight
    // the classes of MBs x + 1 and x + 2, loaded an MB ahead of their use
    const int* const row_info = info + (size_t)(f * n + r * mb_w) * INFO_W;
    int nxt = __ldg(row_info), nxt2 = mb_w > 1 ? __ldg(row_info + INFO_W) : -1;
    bool left_intra = false;
    for (int x = 0; x < mb_w; ++x) {
      const int mb = f * n + r * mb_w + x;
      const bool me = is_intra(nxt);
      nxt = nxt2;
      nxt2 = x + 2 < mb_w ? __ldg(row_info + (size_t)(x + 2) * INFO_W) : -1;
      const bool lft = left_intra;
      left_intra = me;
      if (!me) {
        if (tid == 0) rows::st_release(prog, x + 1);
        continue;
      }
      const bool next = is_intra(nxt);
      // this MB's residuals and row unless staged, then the next MB's
      if (staged != x) stage_mb(sm, x & 1, res_y, res_u, res_v, info, mb, tid);
      cp_commit();
      if (next)
        stage_mb(sm, (x + 1) & 1, res_y, res_u, res_v, info, mb + 1, tid);
      cp_commit();
      staged = next ? x + 1 : -1;
      const int y0 = 16 * r + WPAD, x0 = 16 * x + WPAD;
      const int cy = 8 * r + WPAD, cx = 8 * x + WPAD;
      if (warp == 0) {
        // an inter (or margin) left column from the plane, before the wait
        int lv = 0;
        if (!lft) {
          if (lane < 16) lv = __ldcg(Yf + (size_t)(y0 + lane) * ws + x0 - 1);
          else if (lane < 24)
            lv = __ldcg(Uf + (size_t)(cy + lane - 16) * cws + cx - 1);
          else lv = __ldcg(Vf + (size_t)(cy + lane - 24) * cws + cx - 1);
        }
        if (r > 0) rows::wait_row(prog - 1, min(x + 2, mb_w), seen, lane);
        // the row above: 25 luma words (top-left and top-right included)
        // and 9 + 9 chroma words, through L2 (another SM wrote them)
        int a = 0, b = 0;
        if (lane < 25) a = __ldcg(Yf + (size_t)(y0 - 1) * ws + x0 - 1 + lane);
        if (lane < 9) b = __ldcg(Uf + (size_t)(cy - 1) * cws + cx - 1 + lane);
        else if (lane < 18)
          b = __ldcg(Vf + (size_t)(cy - 1) * cws + cx - 10 + lane);
        if (lane < 25) sm.ctx[0][lane] = a;
        if (lane < 9) sm.cu[0][lane] = b;
        else if (lane < 18) sm.cv[0][lane - 9] = b;
        if (!lft) {
          if (lane < 16) sm.ctx[1 + lane][0] = lv;
          else if (lane < 24) sm.cu[lane - 15][0] = lv;
          else sm.cv[lane - 23][0] = lv;
        }
      }
      cp_wait<1>();
      __syncthreads();
      const int* const inf = sm.inf[x & 1];
      const int* const res = sm.res[x & 1];
      const int cls = inf[0];
      const bool aL = inf[1], aT = inf[2], aTL = inf[3], aTR = inf[4];
      if (warp < 2) {
        if (cls == 1)
          recon_i16(sm, clampi(inf[6], 0, 3), aL, aT, res, tid);
        else if (cls == 2 || inf[5] != 0)
          recon_i8(sm, inf + 8, aL, aT, aTL, aTR, res, tid);
        else if (warp == 0)
          recon_i4(sm, inf + 8, aL, aT, aTR, res, lane, kinds);
      } else {
        recon_chroma(warp == 2 ? sm.cu : sm.cv, clampi(inf[7], 0, 3), aL, aT,
                     res + (warp == 2 ? 256 : 320), lane);
      }
      __syncthreads();
      // the bottom rows, which the row below reads, then the publish
      int* const Yt = Yf + (size_t)y0 * ws + x0;
      int* const Ut = Uf + (size_t)cy * cws + cx;
      int* const Vt = Vf + (size_t)cy * cws + cx;
      if (tid < 16) Yt[15 * ws + tid] = sm.ctx[16][1 + tid];
      else if (tid < 24) Ut[7 * cws + tid - 16] = sm.cu[8][tid - 15];
      else if (tid < 32) Vt[7 * cws + tid - 24] = sm.cv[8][tid - 23];
      rows::publish_block(prog, x + 1);
      // the other rows (240 + 56 + 56 words), and the right columns that
      // the next MB takes as its left
      for (int k = tid; k < 352; k += NTHREADS) {
        if (k < 240) {
          Yt[(k >> 4) * ws + (k & 15)] = sm.ctx[1 + (k >> 4)][1 + (k & 15)];
        } else {
          const int j = (k - 240) % 56;
          const int(&c)[9][9] = k < 296 ? sm.cu : sm.cv;
          (k < 296 ? Ut : Vt)[(j >> 3) * cws + (j & 7)] =
              c[1 + (j >> 3)][1 + (j & 7)];
        }
      }
      if (warp == 0) {
        if (lane < 16) sm.ctx[1 + lane][0] = sm.ctx[1 + lane][16];
        else if (lane < 24) sm.cu[lane - 15][0] = sm.cu[lane - 15][8];
        else sm.cv[lane - 23][0] = sm.cv[lane - 23][8];
      }
    }
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
