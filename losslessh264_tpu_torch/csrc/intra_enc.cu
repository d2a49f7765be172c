// K4: the encoder's intra wavefront (mode decision, forward transform,
// quantization and decoder-exact recon of every intra MB of a frame), as
// one persistent launch that walks the MB rows.
//
// Replaces the compiled scan of losslessh264_tpu/encoder_jax.py:280-370
// intra_wavefront (jax.lax.scan at :362). Plain torch version:
// losslessh264_tpu_torch/encoder_torch.py intra_wavefront_plain over
// _encode_luma_mb / _encode_chroma_mb; wrapper encoder_torch.
// intra_wavefront.
//
// Layout: the int32 working planes (WPAD = 8 zeros around the picture,
// the inter recon in place, 0 at intra MBs), written in place; the source
// planes as int32 [H, W] and [H/2, W/2]; one int32 row per MB: is intra,
// aL, aT, aTR (the availability of _intra_schedule: aT needs the row
// above in the same slice); per-MB qp and chroma qp. Each intra MB writes
// its row of 427 symbol columns (O_* below; the wrapper fills the rows of
// the other MBs with their defaults). The tables come from the wrapper
// (encoder_torch.K4_TABLES): the 4x4 decode order, the top-right kinds,
// the quantizer and dequantizer scales per qp % 6 and position, LAMBDA
// per qp, the flat weights, the zigzag and the 4x4 directional table.
//
// What bounds it on the H100:
// - dependencies: as K3 (csrc/intra_dec.cu), a chain of 2*(mb_h-1)+mb_w
//   dependent MB steps (168 at 720p), and inside each MB the I4x4 search:
//   blocks that predict from the recon of their left, top, top-left and
//   (where _I4_TR_KIND is 1) top-right neighbours, each 9 candidate
//   modes, a transform, the quantizer and the recon. At most 45 MB rows
//   are in flight at 720p, so ~87 of the 132 SMs have no row: the step
//   is one MB's latency, and an MB can use a whole SM.
// - bytes and operations: the uint8 source and recon planes (1.38 MB
//   each at 720p) and the int32 symbol rows (6.15 MB) move ~9 MB, 2.7 us
//   at 3.35 TB/s; the I4x4 search alone is ~35k int32 operations per MB
//   (16 blocks x 9 modes x 16 samples), ~48k with the rest, 173 M at
//   720p, 5.2 us at 33.5 TOP/s. Either is far below the chain.
// What the design does about each:
// - one CTA of 11 warps per MB row (rows claimed in order from a device
//   counter, csrc/wavefront.cuh). Warps 0-8 run the I4x4 search, warp 9
//   I16x16 and warp 10 chroma, all at once: I16x16 and chroma need only
//   the MB's context, which is complete when the step starts. Chroma
//   writes its symbols itself; its recon and I16x16's levels and recon
//   wait in shared memory for the I4x4-or-I16x16 decision.
// - the I4x4 blocks go by the levels of their dependency graph, (by, bx)
//   at level bx + 2 by: 10 levels of at most 2 blocks instead of 16
//   blocks in turn (the summed cost is an integer sum, so the order does
//   not change it; the MPM border stays DC). Each level gives every
//   (block, mode, sample) its own thread, 2 x 9 x 16 = 288: a thread
//   holds its _TAB4 row in registers, takes its 3 edge samples from its
//   16 lanes by shuffles, its mode's SAD is one warp reduction (redux),
//   and one lane per mode puts (cost << 4 | mode) into a shared atomicMin,
//   whose least key is the first minimum, as torch.argmin takes it. After
//   a group barrier only the warps that hold a chosen mode run its
//   transform, quantizer, inverse and recon by shuffles (running them for
//   all 9 modes before the choice cost more issue slots than the latency
//   it hid), and a second barrier ends the level. The 10 levels' search
//   and transform chains are now the longest part of an MB step, then
//   the hand-off and stores, then I16x16 and chroma beside them
//   (`tools/kernel_ab.py k4 --parts` times builds without each part).
// - only the row above crosses the hand-off: the next intra MB's source
//   tiles are staged by cp.async one MB ahead, its MB row (int4) is read
//   an MB ahead, the left column of an intra left neighbour stays in
//   shared memory from the CTA's own previous MB (the final recon, after
//   the I4x4/I16x16 decision), and that of an inter one is loaded from the
//   plane before the wait. After the wait (ld.acquire.gpu by one thread
//   until the row above has published >= min(x+2, mb_w)) warp 0 reads the
//   25 + 9 + 9 words of the row above. The CTA stores the bottom rows that
//   the row below reads, publishes x+1 (__syncthreads, __threadfence,
//   st.release.gpu), and then stores the rest of the recon and the symbol
//   row, which no other MB reads. A non-intra MB only publishes.
// - the I16x16 and chroma DC sums and plane parameters are computed once
//   per MB, not once per sample.
#include <atomic>
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_common.cuh"

namespace {

using namespace intra;

constexpr int BIG = 1 << 30;   // encoder_torch.BIG
// the packed tables (encoder_torch.K4_TABLES)
constexpr int T_TRK = 16;      // _I4_TR_KIND [16] (after BLK_ORDER [16])
constexpr int T_MF = 32;       // MF4_V [6, 16]
constexpr int T_DEQ = 128;     // DEQ4_V [6, 16]
constexpr int T_LAM = 224;     // LAMBDA [52]
constexpr int T_FLAT = 276;    // FLAT4 [16]
constexpr int T_ZZ = 292;      // ZZ4 [16]
constexpr int T_TAB4 = 308;    // _TAB4 [9, 16, 8]
constexpr int T_LEN = T_TAB4 + 9 * 16 * 8;
// a symbol row: the fetch layout (encoder_torch.K4_ROW, _sym_rows)
constexpr int O_LDC = 0, O_LAC = 16, O_CDC = 272, O_CAC = 280, O_I16 = 408,
              O_CM = 409, O_CLS = 410, O_I4 = 411, ROW = 427;
// the CTA: 2 I4x4 slots of 9 modes x 16 samples, then a warp for I16x16
// and one for chroma
constexpr int SLOT = 9 * 16;
constexpr int I4_THREADS = 2 * SLOT;            // warps 0-8
constexpr int W16 = I4_THREADS / 32;            // warp 9
constexpr int WCH = W16 + 1;                    // warp 10
constexpr int NTHREADS = (WCH + 1) * 32;        // 352
constexpr int BAR_I4 = 1;                       // the I4x4 warps' barrier

struct Smem {
  alignas(16) int src[2][384];   // staged source tiles: Y 256, U 64, V 64
  alignas(16) int tab[T_LEN];
  int ctx[17][25];   // row 0: above (col 0 the above-left), col 0: left;
                     // I4x4 reconstructs in place
  int cu[9][9];
  int cv[9][9];
  int p16[256];      // the chosen I16x16 prediction
  int t16[256];      // the I16x16 recon
  int q16[16][16];   // I16x16 AC levels, raster position per block
  int q4[16][16];    // I4x4 levels
  int qdc[16];       // the quantized Hadamard transform of the DC terms
  int grid[5][5];    // the MPM grid of chosen I4x4 modes (2 outside)
  int m4[16];
  int keys[2][2];    // per level parity and slot: the least (cost << 4 |
                     // mode) of the level's block
  int total[2];      // the summed I4x4 cost per slot
  int sad16, mode16;
  int pc[2][64];     // the chosen chroma predictions
  int qc[2][4][16];  // chroma AC levels
  int wdc[2][4];     // chroma DC coefficients
  int cdq[2][4];     // their quantized 2x2 transform
  int cdd[2][4];     // the dequantized chroma DC per block
  int claim;
};

// output i of the forward 4-point core transform (ops/transform.
// _fwd4_last) of (a0, a1, a2, a3)
__device__ __forceinline__ int fwd4_at(int a0, int a1, int a2, int a3,
                                       int i) {
  const int s0 = a0 + a3, s1 = a1 + a2, d0 = a0 - a3, d1 = a1 - a2;
  return i == 0 ? s0 + s1 : i == 1 ? 2 * d0 + d1 : i == 2 ? s0 - s1
                                                          : d0 - 2 * d1;
}

// output i of the inverse 4-point core transform (ops/transform.
// _idct4_1d)
__device__ __forceinline__ int inv4_at(int a0, int a1, int a2, int a3,
                                       int i) {
  const int e0 = a0 + a2, e1 = a0 - a2, e2 = (a1 >> 1) - a3,
            e3 = a1 + (a3 >> 1);
  return i == 0 ? e0 + e3 : i == 1 ? e1 + e2 : i == 2 ? e1 - e2 : e0 - e3;
}

// output i of the 4-point Hadamard transform of the luma DC terms
// (fhadamard4x4's rows and columns)
__device__ __forceinline__ int had_at(int a0, int a1, int a2, int a3, int i) {
  const int s0 = a0 + a3, s1 = a1 + a2, d0 = a0 - a3, d1 = a1 - a2;
  return i == 0 ? s0 + s1 : i == 1 ? d0 + d1 : i == 2 ? s0 - s1 : d0 - d1;
}

// output i of its inverse (hadamard4x4's rows and columns)
__device__ __forceinline__ int ihad_at(int a0, int a1, int a2, int a3,
                                       int i) {
  const int e0 = a0 + a2, e1 = a0 - a2, e2 = a1 - a3, e3 = a1 + a3;
  return i == 0 ? e0 + e3 : i == 1 ? e1 + e2 : i == 2 ? e1 - e2 : e0 - e3;
}

// the forward 4-point core transform in place
__device__ __forceinline__ void fwd4(int& a0, int& a1, int& a2, int& a3) {
  const int s0 = a0 + a3, s1 = a1 + a2, d0 = a0 - a3, d1 = a1 - a2;
  a0 = s0 + s1;
  a1 = 2 * d0 + d1;
  a2 = s0 - s1;
  a3 = d0 - 2 * d1;
}

// the inverse 4-point core transform in place
__device__ __forceinline__ void inv4(int& a0, int& a1, int& a2, int& a3) {
  const int e0 = a0 + a2, e1 = a0 - a2, e2 = (a1 >> 1) - a3,
            e3 = a1 + (a3 >> 1);
  a0 = e0 + e3;
  a1 = e1 + e2;
  a2 = e1 - e2;
  a3 = e0 - e3;
}

// forward 4x4 transform in registers: rows, then columns (fdct4x4)
__device__ __forceinline__ void fdct16(int (&w)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) fwd4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                   w[4 * i + 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) fwd4(w[j], w[4 + j], w[8 + j], w[12 + j]);
}

// inverse 4x4 transform with its (x + 32) >> 6 (idct4x4)
__device__ __forceinline__ void idct16(int (&w)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) inv4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                   w[4 * i + 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) inv4(w[j], w[4 + j], w[8 + j], w[12 + j]);
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = (w[k] + 32) >> 6;
}

// quant4 (intra rounding offset base // 3) of one coefficient
__device__ __forceinline__ int quant(const Smem& sm, int w, int pos, int qp) {
  const int qbits = 15 + qp / 6;
  const int f = (1 << qbits) / 3;
  const int z = (abs(w) * sm.tab[T_MF + (qp % 6) * 16 + pos] + f) >> qbits;
  return w < 0 ? -z : z;
}

// quant_dc4 / quant_dc2 of one Hadamard-transformed DC term
__device__ __forceinline__ int quant_dc(const Smem& sm, int y, int qp) {
  const int qbits = 15 + qp / 6;
  const int f = (1 << qbits) / 3;
  const int z = (abs(y) * sm.tab[T_MF + (qp % 6) * 16] + 2 * f) >> (qbits + 1);
  return y < 0 ? -z : z;
}

// dequant4 with the flat weights of one level
__device__ __forceinline__ int dequant(const Smem& sm, int c, int pos,
                                       int qp) {
  const int v = c * sm.tab[T_FLAT + pos] * sm.tab[T_DEQ + (qp % 6) * 16 + pos];
  const int qdiv = qp / 6;
  if (qdiv >= 4) return v * (1 << (qdiv - 4));
  return (v + (1 << (3 - qdiv))) >> (4 - qdiv);
}

// I16x16 on one warp: the four modes' SADs, the first legal minimum
// (sm.mode16, its SAD sm.sad16), the transform of the residual, the DC
// Hadamard path and the decoder-exact recon into sm.t16
__device__ void encode_i16(Smem& sm, const int* src, int qp, bool aL,
                           bool aT, int lane) {
  const int i = lane & 15;
  const int lt = lane < 16 ? sm.ctx[1 + i][0] | (sm.ctx[0][1 + i] << 16) : 0;
  const int sums = warp_sum(lt);   // low 16 bits the left, high the top
  const int dc = dc_value(sums & 0xffff, sums >> 16, aL, aT, 4);
  const Plane pl = plane_params(&sm.ctx[1][0], 25, &sm.ctx[0][1],
                                sm.ctx[0][0], 16);
  int sad[4] = {0, 0, 0, 0};
  for (int p = lane; p < 256; p += 32) {
    const int y = p >> 4, x = p & 15, s = src[p];
    sad[0] += abs(s - sm.ctx[0][1 + x]);
    sad[1] += abs(s - sm.ctx[1 + y][0]);
    sad[2] += abs(s - dc);
    sad[3] += abs(s - pl.at(x, y));
  }
  const bool legal[4] = {aT, aL, true, aL && aT};
  int mode = 0, best = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c = legal[m] ? warp_sum(sad[m]) : BIG;
    if (m == 0 || c < best) {
      best = c;
      mode = m;
    }
  }
  if (lane == 0) {
    sm.sad16 = best;
    sm.mode16 = mode;
  }
  for (int p = lane; p < 256; p += 32) {
    const int y = p >> 4, x = p & 15;
    sm.p16[p] = mode == 0   ? sm.ctx[0][1 + x]
                : mode == 1 ? sm.ctx[1 + y][0]
                : mode == 2 ? dc
                            : pl.at(x, y);
  }
  __syncwarp();
  // block b = lane % 16 (both half warps compute it; the lower half
  // writes): the transform and its AC levels, in registers
  const int b = lane & 15, by = b >> 2, bx = b & 3;
  int w[16], lv[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int o = (4 * by + (k >> 2)) * 16 + 4 * bx + (k & 3);
    w[k] = src[o] - sm.p16[o];
  }
  fdct16(w);
  // the quantizer's and dequantizer's scales of this qp, by position
  int mf[16], dq[16];
  {
    const int4* const m4 = reinterpret_cast<const int4*>(
        &sm.tab[T_MF + (qp % 6) * 16]);
    const int4* const d4 = reinterpret_cast<const int4*>(
        &sm.tab[T_DEQ + (qp % 6) * 16]);
    const int4* const f4 = reinterpret_cast<const int4*>(&sm.tab[T_FLAT]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 a = m4[k], b = d4[k], c = f4[k];
      mf[4 * k] = a.x; mf[4 * k + 1] = a.y; mf[4 * k + 2] = a.z;
      mf[4 * k + 3] = a.w;
      dq[4 * k] = b.x * c.x; dq[4 * k + 1] = b.y * c.y;
      dq[4 * k + 2] = b.z * c.z; dq[4 * k + 3] = b.w * c.w;
    }
  }
  const int qbits = 15 + qp / 6, qf = (1 << qbits) / 3, qdiv = qp / 6;
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    const int z = (abs(w[k]) * mf[k] + qf) >> qbits;
    lv[k] = w[k] < 0 ? -z : z;
  }
  // the 16 DC terms, one a lane: the Hadamard transform (rows are lanes
  // 4 by .. 4 by + 3, columns bx, bx + 4, ...), the quantizer of the
  // floored half, the inverse and the dequantizer (luma_dc_dequant with
  // w00 = 16)
  int h = w[0];
  h = had_at(__shfl_sync(FULL, h, 0, 4), __shfl_sync(FULL, h, 1, 4),
             __shfl_sync(FULL, h, 2, 4), __shfl_sync(FULL, h, 3, 4), bx);
  h = had_at(__shfl_sync(FULL, h, bx, 16), __shfl_sync(FULL, h, bx + 4, 16),
             __shfl_sync(FULL, h, bx + 8, 16),
             __shfl_sync(FULL, h, bx + 12, 16), by);
  const int qd = quant_dc(sm, h >> 1, qp);
  int g = ihad_at(__shfl_sync(FULL, qd, 0, 4), __shfl_sync(FULL, qd, 1, 4),
                  __shfl_sync(FULL, qd, 2, 4), __shfl_sync(FULL, qd, 3, 4),
                  bx);
  g = ihad_at(__shfl_sync(FULL, g, bx, 16), __shfl_sync(FULL, g, bx + 4, 16),
              __shfl_sync(FULL, g, bx + 8, 16),
              __shfl_sync(FULL, g, bx + 12, 16), by);
  const int v = g * 16 * sm.tab[T_DEQ + (qp % 6) * 16];
  w[0] = qdiv >= 6 ? v * (1 << (qdiv - 6))
                   : (v + (1 << (5 - qdiv))) >> (6 - qdiv);
  // dequantize, inverse, add the prediction
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    const int d = lv[k] * dq[k];
    w[k] = qdiv >= 4 ? d * (1 << (qdiv - 4))
                     : (d + (1 << (3 - qdiv))) >> (4 - qdiv);
  }
  idct16(w);
  if (lane < 16) {
    sm.qdc[b] = qd;
    sm.q16[b][0] = 0;
#pragma unroll
    for (int k = 1; k < 16; ++k) sm.q16[b][k] = lv[k];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int o = (4 * by + (k >> 2)) * 16 + 4 * bx + (k & 3);
      sm.t16[o] = clamp255(sm.p16[o] + w[k]);
    }
  }
}

// the raster index of slot `slot`'s I4x4 block at dependency level L
// (the blocks with bx + 2 by == L, slot 1 one block row below slot 0),
// or -1 where the level has no such block
__host__ __device__ constexpr int level_blk(int slot, int L) {
  return (L > 3 ? (L - 2) >> 1 : 0) + slot > 3 ||
                 L - 2 * ((L > 3 ? (L - 2) >> 1 : 0) + slot) < 0
             ? -1
             : ((L > 3 ? (L - 2) >> 1 : 0) + slot) * 4 + L -
                   2 * ((L > 3 ? (L - 2) >> 1 : 0) + slot);
}

// the sum of v over the lane's half warp
__device__ __forceinline__ int half_sum(int v, bool upper) {
  const int lo = __reduce_add_sync(FULL, upper ? 0 : v);
  const int hi = __reduce_add_sync(FULL, upper ? v : 0);
  return upper ? hi : lo;
}

// One I4x4 thread: slot (block) `slot`, mode m, sample p of the block.
struct I4Lane {
  int slot, m, p, py, px, warp;
  bool upper, need_t, need_l;
  int trow[8];     // its _TAB4 row
  int kinds;       // _I4_TR_KIND, 2 bits per raster block
};

// Level L of the I4x4 search for the lane's slot: every (mode, sample)
// predicts its sample from the block's edge (taken from the 16 lanes by
// shuffles), each mode's SAD is one reduction, and one lane per mode
// puts (cost << 4 | mode) into a shared atomicMin, whose least key is the
// first minimum, as torch.argmin takes it. After a group barrier only the
// warps that hold a chosen mode run its transform, quantizer, inverse and
// recon by shuffles (rows are lanes 4 py .. 4 py + 3, columns px, px + 4,
// ...); a second barrier ends the level. A slot without a block at level L
// repeats slot 0's (warp 4, which holds both slots) or rests (warps 5-8),
// and writes nothing.
template <int L>
__device__ __forceinline__ void i4_level(Smem& sm, const int* src,
                                         const I4Lane& t, bool aL, bool aT,
                                         bool aTR, int lam, int mf, int qf,
                                         int qbits, int qdiv, int dq,
                                         int& total) {
  constexpr int b0 = level_blk(0, L), b1 = level_blk(1, L);
  const bool valid = t.slot == 0 || b1 >= 0;
  const int r = t.slot && b1 >= 0 ? b1 : b0;
  const int by = r >> 2, bx = r & 3;
  const int ly = 1 + 4 * by, lx = 1 + 4 * bx;
  const int s = src[(4 * by + t.py) * 16 + 4 * bx + t.px];
  int pred = 0;
  if (valid || t.warp == 4) {
    const int kind = (t.kinds >> (2 * r)) & 3;
    const bool trv = kind == 1 || (kind == 2 && aT) || (kind == 3 && aTR);
    // lane p < 13 holds e[p] of e = [l0..l3, tl, t0..t7]; an unavailable
    // top-right repeats t3
    const int p = t.p, j = p - 5;
    const int* const c = &sm.ctx[0][0];
    const int ev = c[p < 4               ? (ly + p) * 25 + lx - 1
                     : p == 4 || p > 12 ? (ly - 1) * 25 + lx - 1
                                        : (ly - 1) * 25 + lx +
                                              (trv || j < 4 ? j : 3)];
    const bool bL = bx > 0 || aL, bT = by > 0 || aT;
    const int e0 = __shfl_sync(FULL, ev, t.trow[0] & 15, 16);
    const int e1 = __shfl_sync(FULL, ev, t.trow[1] & 15, 16);
    const int e2 = __shfl_sync(FULL, ev, t.trow[2] & 15, 16);
    pred = table_pred(t.trow, e0, e1, e2);
    if (t.m == 2) {
      int ls = 0, ts = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ls += c[(ly + i) * 25 + lx - 1];
        ts += c[(ly - 1) * 25 + lx + i];
      }
      pred = dc_value(ls, ts, bL, bT, 2);
    }
    const int sad = half_sum(abs(pred - s), t.upper);
    const bool legal = (!t.need_t || bT) && (!t.need_l || bL);
    const int pm = bL && bT ? min(sm.grid[1 + by][bx], sm.grid[by][1 + bx])
                            : 2;
    if (p == 0)
      atomicMin(&sm.keys[L & 1][t.slot],
                legal ? (sad + lam * (t.m == pm ? 1 : 4)) << 4 | t.m
                      : INT_MAX);
  }
  if (t.slot == 0 && t.m == 0 && t.p < 2) sm.keys[(L + 1) & 1][t.p] = INT_MAX;
  group_sync(BAR_I4, I4_THREADS);
  const int key = sm.keys[L & 1][t.slot];
  if (valid) total += key >> 4;
  const bool chosen = valid && t.m == (key & 15);
  if (__any_sync(FULL, chosen)) {
    const int px = t.px, py = t.py;
    int w = s - pred;
    w = fwd4_at(__shfl_sync(FULL, w, 0, 4), __shfl_sync(FULL, w, 1, 4),
                __shfl_sync(FULL, w, 2, 4), __shfl_sync(FULL, w, 3, 4), px);
    w = fwd4_at(__shfl_sync(FULL, w, px, 16),
                __shfl_sync(FULL, w, px + 4, 16),
                __shfl_sync(FULL, w, px + 8, 16),
                __shfl_sync(FULL, w, px + 12, 16), py);
    const int z = (abs(w) * mf + qf) >> qbits;
    const int q = w < 0 ? -z : z;
    const int v = q * dq;
    int cf = qdiv >= 4 ? v * (1 << (qdiv - 4))
                       : (v + (1 << (3 - qdiv))) >> (4 - qdiv);
    cf = inv4_at(__shfl_sync(FULL, cf, 0, 4), __shfl_sync(FULL, cf, 1, 4),
                 __shfl_sync(FULL, cf, 2, 4), __shfl_sync(FULL, cf, 3, 4),
                 px);
    cf = inv4_at(__shfl_sync(FULL, cf, px, 16),
                 __shfl_sync(FULL, cf, px + 4, 16),
                 __shfl_sync(FULL, cf, px + 8, 16),
                 __shfl_sync(FULL, cf, px + 12, 16), py);
    if (chosen) {
      sm.ctx[ly + py][lx + px] = clamp255(pred + ((cf + 32) >> 6));
      sm.q4[r][t.p] = q;
      if (t.p == 0) {
        sm.grid[1 + by][1 + bx] = t.m;
        sm.m4[r] = t.m;
      }
    }
  }
  group_sync(BAR_I4, I4_THREADS);
}

// I4x4 on the I4_THREADS threads: the blocks by dependency level, each
// mode chosen by SAD + lambda x (1 for the most probable mode, else 4),
// quantized and reconstructed in sm.ctx before the levels that read it.
// Leaves each slot's summed cost in sm.total.
__device__ void encode_i4(Smem& sm, const int* src, int qp, bool aL, bool aT,
                          bool aTR, const I4Lane& t) {
  const int lam = sm.tab[T_LAM + qp];
  const int qbits = 15 + qp / 6, qdiv = qp / 6;
  const int qf = (1 << qbits) / 3;
  const int mf = sm.tab[T_MF + (qp % 6) * 16 + t.p];
  const int dq = sm.tab[T_FLAT + t.p] * sm.tab[T_DEQ + (qp % 6) * 16 + t.p];
  int total = 0;
#define I4_LEVEL(L)                                                        \
  i4_level<L>(sm, src, t, aL, aT, aTR, lam, mf, qf, qbits, qdiv, dq, total)
  I4_LEVEL(0);
  I4_LEVEL(1);
  I4_LEVEL(2);
  I4_LEVEL(3);
  I4_LEVEL(4);
  I4_LEVEL(5);
  I4_LEVEL(6);
  I4_LEVEL(7);
  I4_LEVEL(8);
  I4_LEVEL(9);
#undef I4_LEVEL
  if (t.m == 0 && t.p == 0) sm.total[t.slot] = total;
}

// intra chroma on one warp: the mode from the U + V SAD, then per plane
// the 4x4 transforms, the 2x2 DC path and the recon into the interior of
// sm.cu / sm.cv, and the symbols straight to the symbol row
__device__ void encode_chroma(Smem& sm, const int* su, const int* sv, int qpc,
                              bool aL, bool aT, int* row, int lane) {
  const Chroma pu = chroma_params(sm.cu, aL, aT);
  const Chroma pv = chroma_params(sm.cv, aL, aT);
  int sad[4] = {0, 0, 0, 0};
  for (int p = lane; p < 64; p += 32) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      sad[m] += abs(su[p] - chroma_at(sm.cu, pu, m, p)) +
                abs(sv[p] - chroma_at(sm.cv, pv, m, p));
  }
  const bool legal[4] = {true, aL, aT, aL && aT};
  int cmode = 0, best = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c = legal[m] ? warp_sum(sad[m]) : BIG;
    if (m == 0 || c < best) {
      best = c;
      cmode = m;
    }
  }
  for (int q = lane; q < 128; q += 32)
    sm.pc[q >> 6][q & 63] = q >= 64 ? chroma_at(sm.cv, pv, cmode, q & 63)
                                    : chroma_at(sm.cu, pu, cmode, q);
  __syncwarp();
  const int c = lane >> 2, b = lane & 3, by = b >> 1, bx = b & 1;
  if (lane < 8) {   // plane c, block b: transform and AC levels
    const int* s = c ? sv : su;
    int w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int o = (4 * by + (k >> 2)) * 8 + 4 * bx + (k & 3);
      w[k] = s[o] - sm.pc[c][o];
    }
    fdct16(w);
    sm.wdc[c][b] = w[0];
    sm.qc[c][b][0] = 0;
#pragma unroll
    for (int k = 1; k < 16; ++k) sm.qc[c][b][k] = quant(sm, w[k], k, qpc);
  }
  __syncwarp();
  if (lane < 2) {   // plane `lane`: the 2x2 DC path
    const int* w = sm.wdc[lane];
    const int a = w[0], bb = w[1], cc = w[2], dd = w[3];
    const int t[4] = {a + bb + cc + dd, a - bb + cc - dd, a + bb - cc - dd,
                      a - bb - cc + dd};
    int q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = quant_dc(sm, t[k], qpc);
      sm.cdq[lane][k] = q[k];
    }
    const int u[4] = {q[0] + q[1] + q[2] + q[3], q[0] - q[1] + q[2] - q[3],
                      q[0] + q[1] - q[2] - q[3], q[0] - q[1] - q[2] + q[3]};
    const int scale = 16 * sm.tab[T_DEQ + (qpc % 6) * 16];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sm.cdd[lane][k] = (u[k] * scale * (1 << (qpc / 6))) >> 5;
  }
  __syncwarp();
  if (lane < 8) {   // plane c, block b: dequantize, inverse, recon
    int w[16];
    w[0] = sm.cdd[c][b];
#pragma unroll
    for (int k = 1; k < 16; ++k) w[k] = dequant(sm, sm.qc[c][b][k], k, qpc);
    idct16(w);
    int(&dst)[9][9] = c ? sm.cv : sm.cu;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int y = 4 * by + (k >> 2), x = 4 * bx + (k & 3);
      dst[1 + y][1 + x] = clamp255(sm.pc[c][y * 8 + x] + w[k]);
    }
    row[O_CDC + lane] = sm.cdq[c][b];
  }
  for (int k = lane; k < 128; k += 32)
    row[O_CAC + k] = sm.qc[k >> 6][(k >> 4) & 3][sm.tab[T_ZZ + (k & 15)]];
  if (lane == 0) row[O_CM] = cmode;
}

// cp.async of MB (r, x)'s source tiles into buf: 96 chunks of 16 bytes,
// one per thread of the first 96
__device__ __forceinline__ void stage_src(int* buf, const int* sY,
                                          const int* sU, const int* sV, int r,
                                          int x, int W, int CW, int tid) {
  if (tid < 64) {
    const int i = tid >> 2, q = tid & 3;
    cp16(buf + i * 16 + q * 4, sY + (size_t)(16 * r + i) * W + 16 * x + 4 * q);
  } else if (tid < 96) {
    const int j = tid & 15, i = j >> 1, h = j & 1;
    const int* s = tid < 80 ? sU : sV;
    cp16(buf + (tid < 80 ? 256 : 320) + i * 8 + h * 4,
         s + (size_t)(8 * r + i) * CW + 8 * x + 4 * h);
  }
}

// sync[0]: the next MB row to claim; sync[1 + r]: MBs of row r finished
__global__ void __launch_bounds__(NTHREADS)
intra_enc_kernel(int* __restrict__ Y, int* __restrict__ U,
                 int* __restrict__ V, const int* __restrict__ sY,
                 const int* __restrict__ sU, const int* __restrict__ sV,
                 const int* __restrict__ info, const int* __restrict__ qps,
                 const int* __restrict__ qpcs, const int* __restrict__ tables,
                 int* __restrict__ sym, int* __restrict__ sync, int mb_w,
                 int mb_h) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < T_LEN; i += NTHREADS) sm.tab[i] = tables[i];
  if (tid < 4) sm.keys[tid / 2][tid % 2] = INT_MAX;
  __syncthreads();
  // an I4x4 thread's constants: its slot, mode, sample, _TAB4 row, which
  // neighbours its mode needs, and the blocks' top-right kinds
  I4Lane t;
  {
    const int i = tid < I4_THREADS ? tid % SLOT : 0;
    t.slot = tid >= SLOT && tid < I4_THREADS;
    t.m = i >> 4;
    t.p = tid & 15;
    t.py = t.p >> 2;
    t.px = t.p & 3;
    t.warp = warp;
    t.upper = tid & 16;
    t.need_t = t.m == 0 || (t.m >= 3 && t.m <= 7);
    t.need_l = t.m == 1 || (t.m >= 4 && t.m <= 6) || t.m == 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) t.trow[k] = sm.tab[T_TAB4 + i * 8 + k];
    t.kinds = 0;
    for (int r = 0; r < 16; ++r) t.kinds |= (sm.tab[T_TRK + r] & 3) << (2 * r);
  }
  const int ws = mb_w * 16 + 2 * WPAD, cws = mb_w * 8 + 2 * WPAD;
  const int W = mb_w * 16, CW = mb_w * 8;
  for (;;) {
    if (tid == 0) sm.claim = atomicAdd(sync, 1);
    __syncthreads();
    const int r = sm.claim;
    __syncthreads();
    if (r >= mb_h) return;
    int* const prog = sync + 1 + r;
    int seen = 0;
    int staged = -1;   // the MB whose source tiles are in flight
    // the MB rows (is intra, aL, aT, aTR) of MBs x + 1 and x + 2, loaded
    // an MB ahead of their use
    const int4* const row4 = reinterpret_cast<const int4*>(info) +
                             (size_t)r * mb_w;
    const int4 none = make_int4(0, 0, 0, 0);
    int4 nxt = __ldg(row4), nxt2 = mb_w > 1 ? __ldg(row4 + 1) : none;
    bool left_intra = false;
    for (int x = 0; x < mb_w; ++x) {
      const int mb = r * mb_w + x;
      const int4 me = nxt;
      nxt = nxt2;
      nxt2 = x + 2 < mb_w ? __ldg(row4 + x + 2) : none;
      const bool lft = left_intra;
      left_intra = me.x != 0;
      if (!me.x) {
        if (tid == 0) rows::st_release(prog, x + 1);
        continue;
      }
      const bool aL = me.y, aT = me.z, aTR = me.w;
      const int qp = __ldg(qps + mb), qpc = __ldg(qpcs + mb);
      const bool next = nxt.x != 0;
      // this MB's source tiles unless staged, then the next MB's
      if (staged != x) stage_src(sm.src[x & 1], sY, sU, sV, r, x, W, CW, tid);
      cp_commit();
      if (next) stage_src(sm.src[(x + 1) & 1], sY, sU, sV, r, x + 1, W, CW,
                          tid);
      cp_commit();
      staged = next ? x + 1 : -1;
      if (tid < 25) sm.grid[tid / 5][tid % 5] = 2;
      const int y0 = 16 * r + WPAD, x0 = 16 * x + WPAD;
      const int cy = 8 * r + WPAD, cx = 8 * x + WPAD;
      if (warp == 0) {
        // an inter (or margin) left column from the plane, before the wait
        int lv = 0;
        if (!lft) {
          if (lane < 16) lv = __ldcg(Y + (size_t)(y0 + lane) * ws + x0 - 1);
          else if (lane < 24)
            lv = __ldcg(U + (size_t)(cy + lane - 16) * cws + cx - 1);
          else lv = __ldcg(V + (size_t)(cy + lane - 24) * cws + cx - 1);
        }
        if (r > 0) rows::wait_row(prog - 1, min(x + 2, mb_w), seen, lane);
        // the row above: 25 luma words (top-left and top-right included)
        // and 9 + 9 chroma words, through L2 (another SM wrote them)
        int a = 0, b = 0;
        if (lane < 25) a = __ldcg(Y + (size_t)(y0 - 1) * ws + x0 - 1 + lane);
        if (lane < 9) b = __ldcg(U + (size_t)(cy - 1) * cws + cx - 1 + lane);
        else if (lane < 18)
          b = __ldcg(V + (size_t)(cy - 1) * cws + cx - 10 + lane);
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
      const int* const src = sm.src[x & 1];
      int* const row = sym + (size_t)mb * ROW;
      if (tid < I4_THREADS)
        encode_i4(sm, src, qp, aL, aT, aTR, t);
      else if (warp == W16)
        encode_i16(sm, src, qp, aL, aT, lane);
      else
        encode_chroma(sm, src + 256, src + 320, qpc, aL, aT, row, lane);
      __syncthreads();
      // the I16x16 header / mode-bit allowance
      const bool use4 =
          sm.total[0] + sm.total[1] < sm.sad16 + sm.tab[T_LAM + qp] * 6;
      // the bottom rows, which the row below reads, then the publish
      int* const Yt = Y + (size_t)y0 * ws + x0;
      int* const Ut = U + (size_t)cy * cws + cx;
      int* const Vt = V + (size_t)cy * cws + cx;
      if (tid < 16)
        Yt[15 * ws + tid] = use4 ? sm.ctx[16][1 + tid] : sm.t16[240 + tid];
      else if (tid < 24) Ut[7 * cws + tid - 16] = sm.cu[8][tid - 15];
      else if (tid < 32) Vt[7 * cws + tid - 24] = sm.cv[8][tid - 23];
      rows::publish_block(prog, x + 1);
      // the other rows (240 + 56 + 56 words, a thread each), the symbols
      // (read by no other MB), and the right columns that the next MB
      // takes as its left
      if (tid < 240) {
        const int y = tid >> 4, xx = tid & 15;
        Yt[y * ws + xx] = use4 ? sm.ctx[1 + y][1 + xx] : sm.t16[tid];
      } else {
        const int j = (tid - 240) % 56;
        const int(&c)[9][9] = tid < 296 ? sm.cu : sm.cv;
        (tid < 296 ? Ut : Vt)[(j >> 3) * cws + (j & 7)] =
            c[1 + (j >> 3)][1 + (j & 7)];
      }
      if (tid == 0) {
        row[O_I16] = sm.mode16;
        row[O_CLS] = use4 ? 0 : 1;
      }
      if (tid < 16) {
        row[O_I4 + tid] = sm.m4[tid];
        row[O_LDC + tid] = use4 ? 0 : sm.qdc[sm.tab[T_ZZ + tid]];
      }
      for (int k = tid; k < 256; k += NTHREADS) {
        const int b = k >> 4, z = sm.tab[T_ZZ + (k & 15)];
        row[O_LAC + k] = use4 ? sm.q4[b][z] : sm.q16[b][z];
      }
      if (warp == 0) {
        if (lane < 16)
          sm.ctx[1 + lane][0] = use4 ? sm.ctx[1 + lane][16]
                                     : sm.t16[lane * 16 + 15];
        else if (lane < 24) sm.cu[lane - 15][0] = sm.cu[lane - 15][8];
        else sm.cv[lane - 23][0] = sm.cv[lane - 23][8];
      }
    }
  }
}

std::atomic<int> resident[rows::MAX_DEVICES];   // 0: not asked yet

}  // namespace

// Y/U/V: the frame's int32 working planes, written in place at intra MBs;
// sY/sU/sV: int32 source planes; info: [n, 4] int32 (is intra, aL, aT,
// aTR); qp/qpc: [n] int32; tables: the packed tables; sym: [n, 427] int32
// symbol rows, written at intra MBs; sync: device scratch of 1 + mb_h
// int32, zeroed here on `stream`. All contiguous.
extern "C" int pip_intra_enc(void* Y, void* U, void* V, const void* sY,
                             const void* sU, const void* sV, const void* info,
                             const void* qp, const void* qpc,
                             const void* tables, void* sym, void* sync,
                             int mb_w, int mb_h, void* stream) {
  return rows::launch_rows(
      intra_enc_kernel, resident, NTHREADS, mb_h, sync, (size_t)(1 + mb_h),
      (cudaStream_t)stream, (int*)Y, (int*)U, (int*)V, (const int*)sY,
      (const int*)sU, (const int*)sV, (const int*)info, (const int*)qp,
      (const int*)qpc, (const int*)tables, (int*)sym, (int*)sync, mb_w, mb_h);
}
