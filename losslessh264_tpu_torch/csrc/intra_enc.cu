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
//   16 dependent blocks, each 9 candidate modes, a transform, the
//   quantizer and the recon that the next block predicts from.
// - bytes and operations: the uint8 source and recon planes (1.38 MB
//   each at 720p) and the int32 symbol rows (6.15 MB) move ~9 MB, 2.7 us
//   at 3.35 TB/s; the I4x4 search alone is ~35k int32 operations per MB
//   (16 blocks x 9 modes x 16 samples), ~48k with the rest, 173 M at
//   720p, 5.2 us at 33.5 TOP/s. Either is far below the chain.
// What the design does about each:
// - K2's schedule: one-warp CTAs claim MB rows from a device counter;
//   an intra MB waits (ld.acquire.gpu by lane 0) until the row above has
//   published progress >= min(x+2, mb_w) and publishes x+1 after its
//   stores (st.release.gpu); a non-intra MB only publishes.
// - one warp per MB runs I16x16, then I4x4, then chroma, one after the
//   other: the I4x4 chain is the MB's critical path in any split; I16x16
//   and chroma on warps of their own would shorten the step by their
//   part, at the cost of a block-wide barrier in every step (a later
//   PR's choice). Inside a step the lanes split the work: a lane per
//   candidate mode (its SAD over the block), a warp-wide first minimum,
//   four lanes for the rows and then the columns of each transform, a
//   lane per coefficient of the quantizer.
#include <atomic>
#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_common.cuh"

namespace {

using namespace intra;

constexpr int BIG = 1 << 30;   // encoder_torch.BIG
// the packed tables (encoder_torch.K4_TABLES)
constexpr int T_BLK = 0;       // BLK_ORDER [16]
constexpr int T_TRK = 16;      // _I4_TR_KIND [16]
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

struct Smem {
  int tab[T_LEN];
  int ctx[17][25];   // luma recon context; I4x4 reconstructs in place
  int cu[9][9];
  int cv[9][9];
  int src[256];
  int su[64];
  int sv[64];
  int p16[256];      // the chosen I16x16 prediction
  int t16[256];      // the I16x16 recon
  int q16[16][16];   // I16x16 AC levels, raster position per block
  int q4[16][16];    // I4x4 levels
  int dcs[16];       // the 16 DC coefficients, raster block order
  int qdc[16];       // their quantized Hadamard transform
  int dcd[16];       // the dequantized DC per block
  int edge[13];
  int grid[5][5];    // the MPM grid of chosen I4x4 modes (2 outside)
  int m4[16];
  int pb[16];        // the current 4x4 block's prediction
  int blk[16];       // its transform in place
  int pc[2][64];     // the chosen chroma predictions
  int qc[2][4][16];  // chroma AC levels
  int wdc[2][4];     // chroma DC coefficients
  int cdq[2][4];     // their quantized 2x2 transform
  int cdd[2][4];     // the dequantized chroma DC per block
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the first (lowest-index) minimum of (cost, idx) over the warp, as
// torch.argmin picks it
__device__ __forceinline__ void warp_argmin(int& cost, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, cost, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (oc < cost || (oc == cost && oi < idx)) {
      cost = oc;
      idx = oi;
    }
  }
}

// the forward 4-point core transform (ops/transform._fwd4_last)
__device__ __forceinline__ void fwd4(int& a0, int& a1, int& a2, int& a3) {
  const int s0 = a0 + a3, s1 = a1 + a2, d0 = a0 - a3, d1 = a1 - a2;
  a0 = s0 + s1;
  a1 = 2 * d0 + d1;
  a2 = s0 - s1;
  a3 = d0 - 2 * d1;
}

// the inverse 4-point core transform (ops/transform._idct4_1d)
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

// I16x16: the four modes' SADs, the first legal minimum, the transform of
// the residual, the DC Hadamard path and the decoder-exact recon into
// sm.t16. Returns the mode; *sad its SAD.
__device__ int encode_i16(Smem& sm, int qp, bool aL, bool aT, int lane,
                          int* sad_out) {
  int lsum = 0, tsum = 0;
  for (int i = 0; i < 16; ++i) {
    lsum += sm.ctx[1 + i][0];
    tsum += sm.ctx[0][1 + i];
  }
  const int dc = dc_value(lsum, tsum, aL, aT, 4);
  int sad[4] = {0, 0, 0, 0};
  for (int p = lane; p < 256; p += NTHREADS) {
    const int y = p >> 4, x = p & 15, s = sm.src[p];
    sad[0] += abs(s - sm.ctx[0][1 + x]);
    sad[1] += abs(s - sm.ctx[1 + y][0]);
    sad[2] += abs(s - dc);
    sad[3] += abs(s - plane_sample(&sm.ctx[1][0], 25, &sm.ctx[0][1],
                                   sm.ctx[0][0], 16, x, y));
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
  *sad_out = best;
  for (int p = lane; p < 256; p += NTHREADS) {
    const int y = p >> 4, x = p & 15;
    sm.p16[p] = mode == 0   ? sm.ctx[0][1 + x]
                : mode == 1 ? sm.ctx[1 + y][0]
                : mode == 2 ? dc
                            : plane_sample(&sm.ctx[1][0], 25, &sm.ctx[0][1],
                                           sm.ctx[0][0], 16, x, y);
  }
  __syncwarp();
  if (lane < 16) {   // block `lane`: the transform and its AC levels
    const int by = lane >> 2, bx = lane & 3;
    int w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int o = (4 * by + (k >> 2)) * 16 + 4 * bx + (k & 3);
      w[k] = sm.src[o] - sm.p16[o];
    }
    fdct16(w);
    sm.dcs[lane] = w[0];
    sm.q16[lane][0] = 0;
#pragma unroll
    for (int k = 1; k < 16; ++k) sm.q16[lane][k] = quant(sm, w[k], k, qp);
  }
  __syncwarp();
  if (lane == 0) {   // the DC terms: Hadamard, quantizer, and back
    int h[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) h[k] = sm.dcs[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // fhadamard4x4, rows then columns
      const int s0 = h[4 * i] + h[4 * i + 3], s1 = h[4 * i + 1] + h[4 * i + 2];
      const int d0 = h[4 * i] - h[4 * i + 3], d1 = h[4 * i + 1] - h[4 * i + 2];
      h[4 * i] = s0 + s1;
      h[4 * i + 1] = d0 + d1;
      h[4 * i + 2] = s0 - s1;
      h[4 * i + 3] = d0 - d1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s0 = h[j] + h[12 + j], s1 = h[4 + j] + h[8 + j];
      const int d0 = h[j] - h[12 + j], d1 = h[4 + j] - h[8 + j];
      h[j] = s0 + s1;
      h[4 + j] = d0 + d1;
      h[8 + j] = s0 - s1;
      h[12 + j] = d0 - d1;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      h[k] = quant_dc(sm, h[k] >> 1, qp);   // the floored // 2
      sm.qdc[k] = h[k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // hadamard4x4, rows then columns
      const int e0 = h[4 * i] + h[4 * i + 2], e1 = h[4 * i] - h[4 * i + 2];
      const int e2 = h[4 * i + 1] - h[4 * i + 3],
                e3 = h[4 * i + 1] + h[4 * i + 3];
      h[4 * i] = e0 + e3;
      h[4 * i + 1] = e1 + e2;
      h[4 * i + 2] = e1 - e2;
      h[4 * i + 3] = e0 - e3;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e0 = h[j] + h[8 + j], e1 = h[j] - h[8 + j];
      const int e2 = h[4 + j] - h[12 + j], e3 = h[4 + j] + h[12 + j];
      h[j] = e0 + e3;
      h[4 + j] = e1 + e2;
      h[8 + j] = e1 - e2;
      h[12 + j] = e0 - e3;
    }
    // luma_dc_dequant with w00 = 16
    const int scale = 16 * sm.tab[T_DEQ + (qp % 6) * 16];
    const int qdiv = qp / 6;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int v = h[k] * scale;
      sm.dcd[k] = qdiv >= 6 ? v * (1 << (qdiv - 6))
                            : (v + (1 << (5 - qdiv))) >> (6 - qdiv);
    }
  }
  __syncwarp();
  if (lane < 16) {   // block `lane`: dequantize, inverse, add the prediction
    const int by = lane >> 2, bx = lane & 3;
    int w[16];
    w[0] = sm.dcd[lane];
#pragma unroll
    for (int k = 1; k < 16; ++k) w[k] = dequant(sm, sm.q16[lane][k], k, qp);
    idct16(w);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int o = (4 * by + (k >> 2)) * 16 + 4 * bx + (k & 3);
      sm.t16[o] = clamp255(sm.p16[o] + w[k]);
    }
  }
  __syncwarp();
  return mode;
}

// I4x4: the 16 blocks in coding order, each mode chosen by SAD + lambda x
// (1 for the most probable mode, else 4), quantized and reconstructed in
// sm.ctx before the next. Returns the summed cost.
__device__ int encode_i4(Smem& sm, int qp, bool aL, bool aT, bool aTR,
                         int lane) {
  const int lam = sm.tab[T_LAM + qp];
  if (lane < 25) sm.grid[lane / 5][lane % 5] = 2;
  int total = 0;
  for (int d = 0; d < 16; ++d) {
    const int r = sm.tab[T_BLK + d];
    const int by = r >> 2, bx = r & 3;
    const int ly = 1 + 4 * by, lx = 1 + 4 * bx;
    const int kind = sm.tab[T_TRK + r];
    const bool trv = kind == 1 || (kind == 2 && aT) || (kind == 3 && aTR);
    if (lane < 4) sm.edge[lane] = sm.ctx[ly + lane][lx - 1];
    else if (lane == 4) sm.edge[4] = sm.ctx[ly - 1][lx - 1];
    else if (lane < 13)
      sm.edge[lane] = sm.ctx[ly - 1][lx + ((lane - 5 < 4 || trv) ? lane - 5
                                                                 : 3)];
    __syncwarp();
    const bool bL = bx == 0 ? aL : true, bT = by == 0 ? aT : true;
    const bool both = bL && bT;
    const int* e = sm.edge;
    const int dc =
        dc_value(e[0] + e[1] + e[2] + e[3], e[5] + e[6] + e[7] + e[8], bL, bT,
                 2);
    int cost = INT_MAX, idx = lane;
    if (lane < 9) {   // lane m: mode m's SAD and cost
      const int m = lane;
      int sad = 0;
      for (int p = 0; p < 16; ++p) {
        const int pred =
            m == 2 ? dc : table_sample(&sm.tab[T_TAB4 + (m * 16 + p) * 8], e);
        sad += abs(pred - sm.src[(4 * by + (p >> 2)) * 16 + 4 * bx + (p & 3)]);
      }
      const bool legal = m == 2 || ((m == 0 || m == 3 || m == 7) && bT) ||
                         ((m == 1 || m == 8) && bL) ||
                         (m >= 4 && m <= 6 && both);
      const int pm =
          both ? min(sm.grid[1 + by][bx], sm.grid[by][1 + bx]) : 2;
      cost = legal ? sad + lam * (m == pm ? 1 : 4) : BIG;
    }
    warp_argmin(cost, idx);
    const int m = idx;
    total += cost;
    if (lane < 16) {
      const int pred =
          m == 2 ? dc
                 : table_sample(&sm.tab[T_TAB4 + (m * 16 + lane) * 8], e);
      sm.pb[lane] = pred;
      sm.blk[lane] =
          sm.src[(4 * by + (lane >> 2)) * 16 + 4 * bx + (lane & 3)] - pred;
    }
    __syncwarp();
    if (lane == 0) {
      sm.grid[1 + by][1 + bx] = m;
      sm.m4[r] = m;
    }
    if (lane < 4) {   // forward transform, row `lane`
      int* b = &sm.blk[4 * lane];
      fwd4(b[0], b[1], b[2], b[3]);
    }
    __syncwarp();
    if (lane < 4) {   // column `lane`
      fwd4(sm.blk[lane], sm.blk[4 + lane], sm.blk[8 + lane],
           sm.blk[12 + lane]);
    }
    __syncwarp();
    if (lane < 16) {   // coefficient `lane`: its level, dequantized
      const int q = quant(sm, sm.blk[lane], lane, qp);
      sm.q4[r][lane] = q;
      sm.blk[lane] = dequant(sm, q, lane, qp);
    }
    __syncwarp();
    if (lane < 4) {   // inverse transform, row `lane`
      int* b = &sm.blk[4 * lane];
      inv4(b[0], b[1], b[2], b[3]);
    }
    __syncwarp();
    if (lane < 4) {   // column `lane`, then the recon
      int c0 = sm.blk[lane], c1 = sm.blk[4 + lane], c2 = sm.blk[8 + lane],
          c3 = sm.blk[12 + lane];
      inv4(c0, c1, c2, c3);
      const int c[4] = {c0, c1, c2, c3};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sm.ctx[ly + i][lx + lane] =
            clamp255(sm.pb[4 * i + lane] + ((c[i] + 32) >> 6));
    }
    __syncwarp();
  }
  return total;
}

// intra chroma: the mode from the U + V SAD, then per plane the 4x4
// transforms, the 2x2 DC path and the recon, straight to the planes
__device__ void encode_chroma(Smem& sm, int qpc, bool aL, bool aT, int* U,
                              int* V, int cws, int* row, int lane) {
  int sad[4] = {0, 0, 0, 0};
  for (int p = lane; p < 64; p += NTHREADS) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      sad[m] += abs(sm.su[p] - chroma_pred(sm.cu, m, aL, aT, p)) +
                abs(sm.sv[p] - chroma_pred(sm.cv, m, aL, aT, p));
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
  for (int q = lane; q < 128; q += NTHREADS)
    sm.pc[q >> 6][q & 63] =
        chroma_pred(q >= 64 ? sm.cv : sm.cu, cmode, aL, aT, q & 63);
  __syncwarp();
  const int c = lane >> 2, b = lane & 3, by = b >> 1, bx = b & 1;
  if (lane < 8) {   // plane c, block b: transform and AC levels
    const int* s = c ? sm.sv : sm.su;
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
    int* dst = c ? V : U;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int y = 4 * by + (k >> 2), x = 4 * bx + (k & 3);
      dst[(size_t)y * cws + x] = clamp255(sm.pc[c][y * 8 + x] + w[k]);
    }
    row[O_CDC + lane] = sm.cdq[c][b];
  }
  for (int k = lane; k < 128; k += NTHREADS)
    row[O_CAC + k] =
        sm.qc[k >> 6][(k >> 4) & 3][sm.tab[T_ZZ + (k & 15)]];
  if (lane == 0) row[O_CM] = cmode;
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
  const int lane = threadIdx.x;
  for (int i = lane; i < T_LEN; i += NTHREADS) sm.tab[i] = tables[i];
  __syncwarp();
  const int ws = mb_w * 16 + 2 * WPAD, cws = mb_w * 8 + 2 * WPAD;
  const int W = mb_w * 16, CW = mb_w * 8;
  for (;;) {
    int r = 0;
    if (lane == 0) r = atomicAdd(sync, 1);
    r = __shfl_sync(0xffffffffu, r, 0);
    if (r >= mb_h) return;
    int* const prog = sync + 1 + r;
    int seen = 0;
    for (int x = 0; x < mb_w; ++x) {
      const int mb = r * mb_w + x;
      const int* const inf = info + (size_t)mb * 4;
      if (!__ldg(inf)) {
        publish(prog, x + 1, lane);
        continue;
      }
      const bool aL = __ldg(inf + 1), aT = __ldg(inf + 2),
                 aTR = __ldg(inf + 3);
      const int qp = __ldg(qps + mb), qpc = __ldg(qpcs + mb);
      // the source tiles (read-only) before the wait
      for (int p = lane; p < 256; p += NTHREADS)
        sm.src[p] = __ldg(sY + (size_t)(16 * r + (p >> 4)) * W + 16 * x +
                          (p & 15));
      for (int p = lane; p < 64; p += NTHREADS) {
        const size_t o = (size_t)(8 * r + (p >> 3)) * CW + 8 * x + (p & 7);
        sm.su[p] = __ldg(sU + o);
        sm.sv[p] = __ldg(sV + o);
      }
      if (r > 0) wait_row(prog - 1, min(x + 2, mb_w), seen, lane);
      const int y0 = 16 * r + WPAD, x0 = 16 * x + WPAD;
      const int cy = 8 * r + WPAD, cx = 8 * x + WPAD;
      for (int i = lane; i < 17 * 25; i += NTHREADS)
        sm.ctx[i / 25][i % 25] =
            __ldcg(Y + (size_t)(y0 - 1 + i / 25) * ws + x0 - 1 + i % 25);
      for (int i = lane; i < 81; i += NTHREADS) {
        const size_t o = (size_t)(cy - 1 + i / 9) * cws + cx - 1 + i % 9;
        sm.cu[i / 9][i % 9] = __ldcg(U + o);
        sm.cv[i / 9][i % 9] = __ldcg(V + o);
      }
      __syncwarp();
      int* const row = sym + (size_t)mb * ROW;
      int sad16 = 0;
      const int mode16 = encode_i16(sm, qp, aL, aT, lane, &sad16);
      const int cost4 = encode_i4(sm, qp, aL, aT, aTR, lane);
      // the I16x16 header / mode-bit allowance
      const bool use4 = cost4 < sad16 + sm.tab[T_LAM + qp] * 6;
      if (lane == 0) {
        row[O_I16] = mode16;
        row[O_CLS] = use4 ? 0 : 1;
      }
      if (lane < 16) {
        row[O_I4 + lane] = sm.m4[lane];
        row[O_LDC + lane] = use4 ? 0 : sm.qdc[sm.tab[T_ZZ + lane]];
      }
      for (int k = lane; k < 256; k += NTHREADS) {
        const int b = k >> 4, z = sm.tab[T_ZZ + (k & 15)];
        row[O_LAC + k] = use4 ? sm.q4[b][z] : sm.q16[b][z];
        const int y = k >> 4, xx = k & 15;
        Y[(size_t)(y0 + y) * ws + x0 + xx] =
            use4 ? sm.ctx[1 + y][1 + xx] : sm.t16[k];
      }
      encode_chroma(sm, qpc, aL, aT, U + (size_t)cy * cws + cx,
                    V + (size_t)cy * cws + cx, cws, row, lane);
      publish(prog, x + 1, lane);
    }
    __syncwarp();
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
