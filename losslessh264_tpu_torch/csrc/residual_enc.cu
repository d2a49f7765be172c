// K8: the residual half of the encoder's P-frame analysis, one frame.
//
// Replaces the residual half of encoder_jax.encode_inter_mbs
// (losslessh264_tpu/encoder_jax.py:481-556, inside the jit of :377): the
// intra SAD proxy (ops/me.py:413 intra_sad_proxy) and the intra
// fallback, the writer's partition MVs, chroma MC of the four quadrants
// (ops/mc.py:234 mc_chroma_mbs), the luma and chroma forward transform,
// quantization (inter rounding, the trellis-lite rd_lam), the chroma DC
// path, dequantization, inverse transform and reconstruction, the zigzags
// and no_res. Plain torch version: losslessh264_tpu_torch/encoder_torch.py
// inter_residual_plain; wrapper encoder_torch.inter_residual, which
// encode_inter_mbs calls after the subpel refinement (K1).
//
// The design: a CTA takes a run of RUN = 8 MBs of one MB row (the row's
// last run may be shorter) with warps of two roles, so that no lane idles
// and no warp runs both paths; its outputs leave through shared memory.
// - Staging. The run's source rows (in their dtype) and pred_q go into
//   shared memory by cp.async, in 16-byte chunks where the addresses
//   allow (else 8 or 4), each role staging what it reads. Meanwhile each
//   lane reads its per-MB vectors itself, and a chroma lane its window
//   (below), so that their latency overlaps the staging.
// - A luma warp takes two MBs, a lane per 4x4 block (raster). The MB's
//   source sum (the proxy's rounded mean) and its SAD to the mean are
//   butterflies of shuffles within the MB's 16 lanes, so every lane has
//   the proxy; lanes 0-3 (the quadrants) take use_intra, the partition
//   and the quadrants' MVs in the writer's partition slots. Then residual
//   = source - pred_q, fdct, quant with rd_lam, the zigzag, dequant (flat
//   16), idct and clip(pred + rec).
// - A chroma warp takes four MBs, a lane per 4x4 block of U or V (block k
//   is quadrant k, so its MV is the quadrant's refined one). Its 5x5
//   window of the width-concatenated reference is read once, a row as two
//   aligned words, the window's start clamped into the plane as
//   mc_chroma_mbs clamps it (xoffC is the chosen reference's x offset);
//   the bilinear eighth-pel prediction, then as luma but the AC quantized
//   with the DC skipped. A plane's 4 DC coefficients meet by shuffles
//   among its 4 lanes: each lane takes the 2x2 Hadamard at its position
//   and quantizes it (its cdc level), then the inverse of the 4 levels
//   and the DC dequant at its position before its inverse transform.
// - Each MB's "some level is not 0" is an OR by shuffles over the lanes
//   of its luma and of its chroma.
// - Stores. The run's levels, tiles, cdc and MVs are contiguous in device
//   memory and leave shared memory as consecutive 16-byte chunks of
//   consecutive threads.
// The two roles stage, meet and store apart, each at a named barrier of
// its own warps, so that the luma warps compute while the chroma windows'
// dependent loads (MV, then window) are in flight; the CTA's one barrier
// meets the two ORs for no_res.
//
// Inputs: the source planes, uint8 or int32 (src_bytes) with their row
// strides (U and V share one), pred_q int32 [4n, 8, 8], mvq_x / mvq_y
// int32 [4n], best_sad, part, xoffC, qp and qpc int32 [n], the uint8
// concatenated chroma references [Hc, Wc] (contiguous, Wc a multiple of
// 4), rd_lam (-1: off). Outputs: use_intra and no_res bool [n], part
// int32 [n], mv8 int32 [n,4,2], the luma levels in zigzag order int32
// [n,16,16], cdc int32 [n,2,4], cac int32 [n,2,4,16], tile_y int32
// [n,16,16], tile_u and tile_v int32 [n,8,8]. The entry refuses buffers
// its loads and stores cannot take (the sources and their strides not on
// 4 bytes, the references not on 4, pred_q, the MVs and the outputs but
// the per-MB ones not on 16); the wrapper copies such buffers first.
//
// What bounds it on the H100: bytes. chip_smoke.k8_bytes_ops counts the
// inputs the outputs depend on, each once, and the outputs: at 720p the
// uint8 source (1.38 MB), pred_q (3.69 MB), the chroma windows' samples
// and the per-MB vectors read, 3.69 MB of luma levels, 0.46 MB of chroma
// levels and 5.53 MB of tiles written, 17.03 MB on a P frame of encode
// A, 0.00508 ms at 3.35 TB/s. ~40 int32 operations a sample take ~0.0017
// ms at 33.5 TOP/s. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/kernel_ab.py k8 in turns, and chip_smoke.py; PERF.md's kernel
// table): 0.0104 ms per P frame of A, 0.49 of the bound, against 0.0141
// for the build before this design (a warp per MB, per-lane loads and
// stores). Its parts: the stores alone take 0.0051 (the bound), with the
// staging, the vectors and the windows 0.0085; the lanes' arithmetic,
// every CTA of the frame computing at once, sets the rest.
#include <cuda_runtime.h>
#include <stdint.h>

#include "transform.cuh"

namespace {

using tx::u32;

constexpr int RUN = 8;                  // MBs per CTA, within one MB row
constexpr int LUMA_WARPS = RUN / 2;     // two MBs a luma warp
constexpr int THREADS = 32 * (LUMA_WARPS + RUN / 4);  // + four MBs a
                                                      // chroma warp
constexpr int CPAD = 16;                // the chroma references' padding
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void *src_y, *src_u, *src_v;
  int src_bytes, y_stride, c_stride;
  const int32_t *pred_q, *mvq_x, *mvq_y, *best_sad, *part, *xoff_c, *qp,
      *qpc;
  const uint8_t *ref_u, *ref_v;
  int ref_h, ref_w, rd_lam;
  uint8_t *use_intra, *no_res;
  int32_t *part_out, *mv8, *qac, *cdc, *cac, *tile_y, *tile_u, *tile_v;
  int mb_w, mb_h;
};

// a run's staged inputs and its outputs, the outputs laid out as in
// device memory
struct __align__(16) Smem {
  uint8_t src_y[16 * RUN * 16 * 4];     // source rows in their dtype
  uint8_t src_c[2][8 * RUN * 8 * 4];
  int32_t pred[RUN][256];               // pred_q
  int32_t qac[RUN][256];                // the luma levels, zigzag
  int32_t tile_y[RUN][256];
  int32_t cac[RUN][128];
  int32_t tile_c[2][RUN][64];
  int32_t cdc[RUN][8];
  int32_t mv8[RUN][8];
  int32_t part[RUN];
  uint8_t intra[RUN], nz_luma[RUN], nz_chroma[RUN];
};

// the sum of v over the aligned group of `width` lanes that holds this
// lane (a butterfly: every lane of the group gets it)
template <int width>
__device__ __forceinline__ u32 group_sum(u32 v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int width>
__device__ __forceinline__ int group_any(int v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1) v |= __shfl_xor_sync(FULL, v, o);
  return v;
}

// ---- staging ----

// rows y0.. y0 + rows - 1, samples x0.. x0 + cols - 1 of a plane (element
// size es, row stride in elements) into shared rows `pitch` samples
// apart, by cp.async in the largest chunks (16, 8 or 4 bytes) that the
// addresses allow, thread tid of nthreads
__device__ void stage_rows(uint8_t* dst, const void* src, int64_t stride,
                           int es, int y0, int x0, int rows, int cols,
                           int pitch, int tid, int nthreads) {
  const uint8_t* s = static_cast<const uint8_t*>(src)
                     + (y0 * stride + x0) * es;
  const int rb = cols * es;
  const uintptr_t all = reinterpret_cast<uintptr_t>(s)
                        | static_cast<uintptr_t>(stride * es) | rb;
  const int cb = all % 16 == 0 ? 16 : all % 8 == 0 ? 8 : 4;
  const int per = rb / cb;
  for (int c = tid; c < rows * per; c += nthreads) {
    const int r = c / per, o = (c % per) * cb;
    uint8_t* d = dst + r * pitch * es + o;
    const uint8_t* g = s + r * stride * es + o;
    if (cb == 16)
      tx::cp_async<16>(d, g);
    else if (cb == 8)
      tx::cp_async<8>(d, g);
    else
      tx::cp_async<4>(d, g);
  }
}

// 4 samples at sample offset s of a staged plane of element size es
__device__ __forceinline__ void row4(const uint8_t* p, int es, int s,
                                     u32* out) {
  if (es == 1) {
    const u32 v = *reinterpret_cast<const uint32_t*>(p + s);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = (v >> (8 * i)) & 255u;
  } else {
    const int4 v = *reinterpret_cast<const int4*>(p + 4 * s);
    out[0] = static_cast<u32>(v.x);
    out[1] = static_cast<u32>(v.y);
    out[2] = static_cast<u32>(v.z);
    out[3] = static_cast<u32>(v.w);
  }
}

__device__ __forceinline__ void store4(int32_t* p, int32_t a, int32_t b,
                                       int32_t c, int32_t d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}

// the levels of a block in zigzag order
__device__ __forceinline__ void put_zigzag(int32_t* zz,
                                           const u32 (&lev)[16]) {
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    store4(zz + i, tx::s32(lev[tx::zz4(i)]), tx::s32(lev[tx::zz4(i + 1)]),
           tx::s32(lev[tx::zz4(i + 2)]), tx::s32(lev[tx::zz4(i + 3)]));
}

// clip(pred + rec) of a block, its rows t samples apart
__device__ __forceinline__ void put_tile(int32_t* tile, int t,
                                         const u32 (&pred)[16],
                                         const u32 (&w)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    store4(tile + r * t, tx::clip255(pred[4 * r] + w[4 * r]),
           tx::clip255(pred[4 * r + 1] + w[4 * r + 1]),
           tx::clip255(pred[4 * r + 2] + w[4 * r + 2]),
           tx::clip255(pred[4 * r + 3] + w[4 * r + 3]));
}

// ---- the lanes ----

// a qp's quantizer MF and dequant scale of each position class, read once
// a lane
struct Scales {
  u32 mf[3], deq[3];
};

__device__ __forceinline__ Scales scales(int qp) {
  Scales s;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.mf[c] = static_cast<u32>(tx::MF4[qp % 6][c]);
    s.deq[c] = static_cast<u32>(tx::V4[qp % 6][c]);
  }
  return s;
}

// what a luma lane reads of device memory itself: the MB's qp, and on
// lanes 0-3 (the quadrants) its SAD, partition and four MVs
struct LumaVecs {
  int qp, best_sad, part;
  int4 mvx, mvy;
};

__device__ __forceinline__ LumaVecs luma_vecs(const Args& a, int m, int k,
                                              bool live) {
  LumaVecs v = {0, 0, 0, make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  if (live) {
    v.qp = a.qp[m];
    if (k < 4) {
      v.best_sad = a.best_sad[m];
      v.part = a.part[m];
      v.mvx = reinterpret_cast<const int4*>(a.mvq_x)[m];
      v.mvy = reinterpret_cast<const int4*>(a.mvq_y)[m];
    }
  }
  return v;
}

// component q of v
__device__ __forceinline__ int pick(const int4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// luma block k (raster) of the run's MB j, a lane of a luma warp, from
// the staged rows into the staged outputs (live: the MB exists; a lane
// that is not live takes part in the shuffles only)
__device__ void luma_lane(const Args& a, Smem& sm, const LumaVecs& v, int j,
                          int k, bool live) {
  const int by = k >> 2, bx = k & 3;
  u32 src[16], pred[16], w[16];
  if (live) {
    const int q = (by >> 1) * 2 + (bx >> 1);
    const int32_t* pq = sm.pred[j] + q * 64 + (by & 1) * 32 + (bx & 1) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      row4(sm.src_y, a.src_bytes, (by * 4 + r) * RUN * 16 + j * 16 + bx * 4,
           src + 4 * r);
      const int4 p = *reinterpret_cast<const int4*>(pq + r * 8);
      pred[4 * r] = static_cast<u32>(p.x);
      pred[4 * r + 1] = static_cast<u32>(p.y);
      pred[4 * r + 2] = static_cast<u32>(p.z);
      pred[4 * r + 3] = static_cast<u32>(p.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) src[i] = pred[i] = 0u;
  }

  // the proxy: the MB's SAD to its rounded mean
  u32 sum = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) sum += src[i];
  const int32_t mean = tx::s32(tx::sra(group_sum<16>(sum) + 128u, 8));
  u32 sad = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int32_t d = tx::s32(src[i]) - mean;
    sad += static_cast<u32>(d < 0 ? -d : d);
  }
  const int32_t proxy = tx::s32(group_sum<16>(sad));

  if (live && k < 4) {
    // use_intra, the partition and its MVs (k = quadrant)
    const bool intra = v.best_sad > proxy + 2048;
    const int part = intra ? 0 : v.part;
    const int src_q = part == 1 ? (k == 1 ? 2 : k)
                    : part == 2 ? k : part == 3 ? k : 0;
    const bool zero = (part == 1 || part == 2) && k >= 2;
    sm.mv8[j][2 * k] = zero ? 0 : pick(v.mvx, src_q);
    sm.mv8[j][2 * k + 1] = zero ? 0 : pick(v.mvy, src_q);
    if (k == 0) {
      sm.intra[j] = intra;
      sm.part[j] = part;
    }
  }

  const int qp = v.qp;
  const Scales sc = scales(qp);
  u32 lev[16];
  int nz = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = src[i] - pred[i];
  tx::fdct4x4(w);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lev[i] = tx::quant_inter(w[i], i, sc.mf[tx::pos4(i)], 15 + qp / 6,
                             a.rd_lam);
    nz |= lev[i] != 0u;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = tx::dequant(lev[i], 16u, sc.deq[tx::pos4(i)], qp / 6, 4);
  tx::idct4x4(w);
  nz = group_any<16>(nz);
  if (live) {
    put_zigzag(sm.qac[j] + k * 16, lev);
    put_tile(sm.tile_y[j] + by * 64 + bx * 4, 16, pred, w);
    if (k == 0) sm.nz_luma[j] = nz;
  }
}

// what a chroma lane reads of device memory itself: the MB's qpc, the
// MV's eighth-pel fractions and its quadrant's 5x5 window of the
// concatenated reference, a row as two aligned words, the window's start
// clamped into the plane as mc_chroma_mbs clamps it
struct ChromaVecs {
  int qpc, fx, fy;
  uint64_t win[5];
};

__device__ __forceinline__ ChromaVecs chroma_vecs(const Args& a, int m,
                                                  int c, int k, bool live) {
  ChromaVecs v = {0, 0, 0, {0, 0, 0, 0, 0}};
  if (live) {
    const int mbx = m % a.mb_w, mby = m / a.mb_w;
    const int by = k >> 1, bx = k & 1;
    v.qpc = a.qpc[m];
    const int mvx = a.mvq_x[4 * m + k], mvy = a.mvq_y[4 * m + k];
    int iy = CPAD + mby * 8 + by * 4 + (mvy >> 3);
    int ix = CPAD + mbx * 8 + bx * 4 + a.xoff_c[m] + (mvx >> 3);
    iy = iy < 0 ? 0 : iy > a.ref_h - 5 ? a.ref_h - 5 : iy;
    ix = ix < 0 ? 0 : ix > a.ref_w - 5 ? a.ref_w - 5 : ix;
    v.fx = mvx & 7;
    v.fy = mvy & 7;
    const uint8_t* row = (c ? a.ref_v : a.ref_u)
                         + static_cast<int64_t>(iy) * a.ref_w + ix;
    const int shift = 8 * static_cast<int>(reinterpret_cast<uintptr_t>(row)
                                           & 3);
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(
        reinterpret_cast<uintptr_t>(row) & ~static_cast<uintptr_t>(3));
    const int wstride = a.ref_w >> 2;     // ref_w is a multiple of 4
#pragma unroll
    for (int r = 0; r < 5; ++r)
      v.win[r] = ((static_cast<uint64_t>(wp[r * wstride + 1]) << 32)
                  | wp[r * wstride]) >> shift;
  }
  return v;
}

// chroma block k (raster in the 8x8, quadrant k) of plane c (0 U, 1 V) of
// the run's MB j, a lane of a chroma warp (live as luma_lane)
__device__ void chroma_lane(const Args& a, Smem& sm, const ChromaVecs& v,
                            int j, int c, int k, bool live) {
  const int by = k >> 1, bx = k & 1, qpc = v.qpc;
  u32 src[16], pred[16], w[16];
  if (live) {
    // the bilinear weights (8 - fx)(8 - fy) A + fx (8 - fy) B + (8 - fx) fy
    // C + fx fy D as (8 - fy) h(A, B) + fy h(C, D), h(A, B) = (8 - fx) A +
    // fx B taken once per window row: the same integers
    const int fx = v.fx, fy = v.fy;
    int h[5][4];
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const u32 lo = static_cast<u32>(v.win[r]);
      const u32 hi = static_cast<u32>(v.win[r] >> 32) & 255u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int A = (lo >> (8 * i)) & 255;
        const int B = i < 3 ? (lo >> (8 * i + 8)) & 255 : hi;
        h[r][i] = (8 - fx) * A + fx * B;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      row4(sm.src_c[c], a.src_bytes, (by * 4 + r) * RUN * 8 + j * 8 + bx * 4,
           src + 4 * r);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pred[4 * r + i] = static_cast<u32>(
            ((8 - fy) * h[r][i] + fy * h[r + 1][i] + 32) >> 6);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) src[i] = pred[i] = 0u;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = src[i] - pred[i];
  tx::fdct4x4(w);

  // the plane's chroma DC levels: fhadamard2x2 of the 4 unquantized DC
  // terms at this lane's position, quant_dc2; then the inverse transform
  // of the 4 levels at this position and its dequant
  const int base = (threadIdx.x & 31) & ~3;
  u32 d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __shfl_sync(FULL, w[0], base + i);
  const u32 dcq = tx::quant_dc(tx::had2_at(d[0], d[1], d[2], d[3], k), qpc);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __shfl_sync(FULL, dcq, base + i);
  const u32 dc = tx::chroma_dc_dequant(tx::had2_at(d[0], d[1], d[2], d[3],
                                                   k), 16u, qpc);

  const Scales sc = scales(qpc);
  u32 lev[16];
  int nz = dcq != 0u;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lev[i] = i == 0 ? 0u
                    : tx::quant_inter(w[i], i, sc.mf[tx::pos4(i)],
                                      15 + qpc / 6, a.rd_lam);
    nz |= lev[i] != 0u;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = tx::dequant(lev[i], 16u, sc.deq[tx::pos4(i)], qpc / 6, 4);
  w[0] = dc;
  tx::idct4x4(w);
  nz = group_any<8>(nz);
  if (live) {
    sm.cdc[j][c * 4 + k] = tx::s32(dcq);
    put_zigzag(sm.cac[j] + (c * 4 + k) * 16, lev);
    put_tile(sm.tile_c[c][j] + by * 32 + bx * 4, 8, pred, w);
    if ((threadIdx.x & 7) == 0) sm.nz_chroma[j] = nz;
  }
}

// an output's chunks of the run, contiguous in device memory, thread tid
// of nthreads
__device__ __forceinline__ void store_out(int32_t* dst, const int32_t* src,
                                          int chunks, int tid, int nthreads) {
  for (int c = tid; c < chunks; c += nthreads)
    reinterpret_cast<int4*>(dst)[c] = reinterpret_cast<const int4*>(src)[c];
}

__global__ void __launch_bounds__(THREADS) residual_enc(const Args a) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mby = blockIdx.y, mbx0 = blockIdx.x * RUN;
  const int nmb = min(RUN, a.mb_w - mbx0);
  const int m0 = mby * a.mb_w + mbx0, es = a.src_bytes;
  const int64_t ml = m0;

  if (warp < LUMA_WARPS) {
    // the luma warps stage the run's luma rows and pred_q, read their
    // per-MB vectors meanwhile, meet at their own barrier, and store their
    // outputs
    constexpr int N = 32 * LUMA_WARPS;
    const int j = 2 * warp + (lane >> 4), k = lane & 15;
    stage_rows(sm.src_y, a.src_y, a.y_stride, es, mby * 16, mbx0 * 16, 16,
               nmb * 16, RUN * 16, tid, N);
    for (int c = tid; c < nmb * 64; c += N)
      tx::cp_async<16>(&sm.pred[0][0] + 4 * c, a.pred_q + ml * 256 + 4 * c);
    tx::cp_async_commit();
    const LumaVecs v = luma_vecs(a, m0 + j, k, j < nmb);
    tx::cp_async_wait<0>();
    tx::bar_sync(1, N);
    luma_lane(a, sm, v, j, k, j < nmb);
    tx::bar_sync(1, N);
    store_out(a.qac + ml * 256, sm.qac[0], nmb * 64, tid, N);
    store_out(a.tile_y + ml * 256, sm.tile_y[0], nmb * 64, tid, N);
    store_out(a.mv8 + ml * 8, sm.mv8[0], nmb * 2, tid, N);
    if (tid < nmb) {
      a.part_out[m0 + tid] = sm.part[tid];
      a.use_intra[m0 + tid] = sm.intra[tid];
    }
  } else {
    // the chroma warps likewise with the chroma rows and their windows
    constexpr int N = THREADS - 32 * LUMA_WARPS;
    const int t = tid - 32 * LUMA_WARPS;
    const int j = 4 * (warp - LUMA_WARPS) + (lane >> 3);
    const int c = (lane >> 2) & 1, k = lane & 3;
    stage_rows(sm.src_c[0], a.src_u, a.c_stride, es, mby * 8, mbx0 * 8, 8,
               nmb * 8, RUN * 8, t, N);
    stage_rows(sm.src_c[1], a.src_v, a.c_stride, es, mby * 8, mbx0 * 8, 8,
               nmb * 8, RUN * 8, t, N);
    tx::cp_async_commit();
    const ChromaVecs v = chroma_vecs(a, m0 + j, c, k, j < nmb);
    tx::cp_async_wait<0>();
    tx::bar_sync(2, N);
    chroma_lane(a, sm, v, j, c, k, j < nmb);
    tx::bar_sync(2, N);
    store_out(a.cac + ml * 128, sm.cac[0], nmb * 32, t, N);
    store_out(a.tile_u + ml * 64, sm.tile_c[0][0], nmb * 16, t, N);
    store_out(a.tile_v + ml * 64, sm.tile_c[1][0], nmb * 16, t, N);
    store_out(a.cdc + ml * 8, sm.cdc[0], nmb * 2, t, N);
  }
  // the CTA's one barrier: no_res meets the luma's and the chroma's ORs
  __syncthreads();
  if (tid < nmb)
    a.no_res[m0 + tid] = !(sm.nz_luma[tid] | sm.nz_chroma[tid]);
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// One frame's residual analysis (see the top of this file). Returns
// cudaErrorMisalignedAddress without a launch when a buffer or a stride
// does not suit the loads and stores, else cudaGetLastError() after the
// launch.
extern "C" int pip_residual_enc(
    const void* src_y, const void* src_u, const void* src_v, int src_bytes,
    int y_stride, int c_stride, const int32_t* pred_q, const int32_t* mvq_x,
    const int32_t* mvq_y, const int32_t* best_sad, const int32_t* part,
    const int32_t* xoff_c, const int32_t* qp, const int32_t* qpc,
    const uint8_t* ref_u, const uint8_t* ref_v, int ref_h, int ref_w,
    int rd_lam, uint8_t* use_intra, uint8_t* no_res, int32_t* part_out,
    int32_t* mv8, int32_t* qac, int32_t* cdc, int32_t* cac, int32_t* tile_y,
    int32_t* tile_u, int32_t* tile_v, int mb_w, int mb_h,
    cudaStream_t stream) {
  const Args a = {src_y, src_u, src_v, src_bytes, y_stride, c_stride,
                  pred_q, mvq_x, mvq_y, best_sad, part, xoff_c, qp, qpc,
                  ref_u, ref_v, ref_h, ref_w, rd_lam, use_intra, no_res,
                  part_out, mv8, qac, cdc, cac, tile_y, tile_u, tile_v,
                  mb_w, mb_h};
  const bool ok = aligned(src_y, 4) && aligned(src_u, 4)
                  && aligned(src_v, 4) && y_stride * src_bytes % 4 == 0
                  && c_stride * src_bytes % 4 == 0 && aligned(pred_q, 16)
                  && aligned(mvq_x, 16) && aligned(mvq_y, 16)
                  && aligned(ref_u, 4) && aligned(ref_v, 4) && ref_w % 4 == 0
                  && aligned(mv8, 16) && aligned(qac, 16) && aligned(cdc, 16)
                  && aligned(cac, 16) && aligned(tile_y, 16)
                  && aligned(tile_u, 16) && aligned(tile_v, 16);
  if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((mb_w + RUN - 1) / RUN, mb_h);
  residual_enc<<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
