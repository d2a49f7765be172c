// K7: the decoder's residual reconstruction of one frame.
//
// Replaces decoder_jax.recon_pre (losslessh264_tpu/decoder_jax.py:693,
// the jit of _residual_and_inter :321-417) but for its motion
// compensation, which K1 and K6 compute before it: the luma and chroma
// residuals (ops/transform.py luma_residuals :314, chroma_residuals :373),
// pred + residual clamped on inter MBs, the PCM overlay and the placement
// into the padded working planes. Plain torch version:
// losslessh264_tpu_torch/decoder_torch.py _residual_recon_plain; wrapper
// decoder_torch._residual_recon, which _residual_and_inter calls with the
// frame's prediction planes.
//
// What it computes: for each MB the residual tiles (res_y [n,16,16],
// res_u and res_v [n,8,8], which the intra pass K3 reads): a 4x4 block's
// dequant and inverse 4x4 transform, on an I16 MB with the DC from the
// inverse Hadamard of the 16 DC levels and its dequant; on an MB that is
// not I16 and has transform8 set, the 8x8 blocks' dequant and inverse 8x8
// transform; chroma's AC with cbp_chroma == 2 and the dequantized 2x2 DC
// transform with cbp_chroma != 0. And the WPAD-padded working planes: the
// PCM samples on a PCM MB when the frame has them, else clip(pred + res,
// 0, 255) on an MB whose 16 ref_slot cells are all >= 0 (pred 0 when the
// frame has no prediction), else 0; the WPAD = 8 border 0.
//
// The design: a CTA of 8 warps takes a run of RUN = 8 MBs of one MB row
// (the row's last run may be shorter), in three phases.
// - Staging. The run's per-MB bytes and ref_slot rows first, then, by
//   16-byte cp.async into shared memory, only what the run's MBs read:
//   the coded blocks' levels (luma_ac, luma8, chroma_ac, the DC levels),
//   a PCM MB's samples, and in a second group the prediction of the
//   inter MBs, whose wait comes after the transforms.
// - Transforms, one path per warp: a warp takes the luma of one 8x8 MB
//   (8 lanes per 8x8 block: each dequantizes and transforms one row, then
//   one column through shared memory, so each block is computed once),
//   or the 4x4 luma blocks of two other MBs (a lane per block; an I16
//   MB's DC Hadamard by rows then columns, once per MB), or the chroma
//   blocks of four MBs (a lane per block). The 8x8 MBs come first in the
//   run's task list, so at most one warp of a CTA mixes two paths.
// - Stores. The residual tiles, contiguous for a run, and the working
//   planes' rows, k MBs giving k x 64 contiguous bytes per luma row, leave
//   shared memory as consecutive 16-byte chunks of consecutive threads,
//   the prediction read in the same pattern. A CTA whose MBs touch the
//   picture's edge also stores the WPAD border beside them (rows above or
//   below, columns left or right, the corners), so no CTA writes only
//   border.
//
// The inputs are the symbol layer's buffers as the decoder uploads them
// (decoder_torch.planes_to_torch): uint8 mb_class, qp, cbp_luma,
// cbp_chroma and transform8 [n]; int16 luma_ac [n,16,4,4], luma_dc
// [n,4,4], luma8 [n,4,8,8] (absent: null, read as 0), chroma_ac
// [n,8,4,4], chroma_dc [n,2,2,2]; int32 ref_slot [n,16]; uint8 pcm [n,384]
// (absent: null); the six int32 [4,4] and two [8,8] weight matrices (read
// only with use_scaling, else flat 16). The wrapper checks each, and
// hands the entry 16-byte aligned buffers (the entry refuses others).
//
// What bounds it on the H100: bytes. chip_smoke.k7_bytes_ops counts what
// the outputs depend on, each once: at 720p the padded int32 planes (5.80
// MB) and the residual tiles (5.53 MB) written, the int32 prediction of
// the inter MBs (up to 5.53 MB) and the levels of the coded blocks read,
// 17.25 MB on a synth720p P frame, 0.00515 ms at 3.35 TB/s. The integer
// work, ~16 operations a sample, takes ~0.0007 ms at the int32 rate.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, and
// tools/kernel_ab.py k7 in turns; PERF.md's kernel table): 0.0094 ms per
// synth720p P frame, 0.55 of the bound, against 0.0169 for the build
// before this design (a thread per 4x4 block). Its parts: a build that
// stores without staging levels or prediction takes 0.0069 (0.75 of the
// bound), one without the transforms 0.0091, so the staging's wait sets
// most of what the stores leave.
#include <cuda_runtime.h>
#include <stdint.h>

#include "transform.cuh"

namespace {

using tx::u32;

constexpr int WPAD = 8;
constexpr int RUN = 8;                // MBs per CTA, within one MB row
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

struct Args {
  const uint8_t *cls, *qp, *cbp_luma, *cbp_chroma, *t8;
  const int16_t *luma_ac, *luma_dc, *luma8, *chroma_ac, *chroma_dc;
  const int32_t* ref_slot;
  const uint8_t* pcm;
  const int32_t* w4[6];
  const int32_t* w8[2];
  const int32_t* pred[3];
  int32_t* plane[3];
  int32_t* res[3];
  int use_scaling, cqp_off[2], mb_w, mb_h;
};

// a run's staged inputs and its residual tiles; every array that moves by
// 16-byte chunks starts on a multiple of 16 bytes
struct __align__(16) Smem {
  int32_t pred_y[16][RUN * 16];     // the run's prediction rows
  int32_t pred_c[2][8][RUN * 8];
  int32_t res_y[RUN][256];          // the residual tiles, as in res_*
  int32_t res_c[2][RUN][64];
  int32_t w4[6][16];                // the weights (flat 16 without
  int32_t w8[2][64];                // use_scaling)
  int16_t luma_ac[RUN][256];
  int16_t luma8[RUN][256];
  int16_t chroma_ac[RUN][128];
  int16_t luma_dc[RUN][16];
  int16_t chroma_dc[RUN][8];
  uint8_t pcm[RUN][384];
  u32 had[RUN][16];                 // an I16 MB's Hadamard after its rows
  int32_t neg[RUN * 4];             // a quarter ref_slot row has a cell < 0
  uint8_t cls[RUN], qp[RUN], cbp[RUN], cbpc[RUN], t8[RUN];
  uint8_t kind[RUN];                // 0 zero, 1 pred + res, 2 PCM
  uint8_t ord[RUN];                 // the 8x8 MBs, then the others
  int n8;
};

// whether H[r][j] is -1 in the 4-point Hadamard H of hadamard4x4 (rows
// ++++, ++--, +--+, +-+-: row r's sign bits at 4r..4r+3)
__device__ __forceinline__ bool hneg(int r, int j) {
  return (0xA6C0 >> (4 * r + j)) & 1;
}

__device__ __forceinline__ bool is_inter(const Smem& sm, int j) {
  return !(sm.neg[4 * j] | sm.neg[4 * j + 1] | sm.neg[4 * j + 2]
           | sm.neg[4 * j + 3]);
}

// what MB j's working-plane samples are: 2 its PCM samples (a PCM MB of a
// frame with the pcm plane), 1 clip(pred + res) (its 16 ref_slot cells
// are >= 0), 0 zero
__device__ __forceinline__ int kind_of(const Args& a, const Smem& sm, int j) {
  return a.pcm != nullptr && sm.cls[j] == 8 ? 2 : is_inter(sm, j) ? 1 : 0;
}

// MB j takes the 8x8 path: transform8 set and not I16
__device__ __forceinline__ bool path8(const Smem& sm, int j) {
  return sm.t8[j] != 0 && sm.cls[j] != 1;
}

__device__ __forceinline__ void store4(int32_t* p, const u32 (&v)[16],
                                       int i) {
  *reinterpret_cast<int4*>(p) = make_int4(tx::s32(v[i]), tx::s32(v[i + 1]),
                                          tx::s32(v[i + 2]),
                                          tx::s32(v[i + 3]));
}

// ---- phase 1: staging ----

// the run's per-MB bytes, the sign of its ref_slot rows and the weights;
// then each MB's kind and the task order (after the caller's barrier)
__device__ void stage_mbs(const Args& a, Smem& sm, int m0, int nmb,
                          int tid) {
  if (tid < nmb * 4) {
    const int4 r = reinterpret_cast<const int4*>(a.ref_slot
                                                 + static_cast<int64_t>(m0)
                                                       * 16)[tid];
    sm.neg[tid] = (r.x | r.y | r.z | r.w) < 0;
  } else if (tid >= 32 && tid < 32 + nmb) {
    const int j = tid - 32, m = m0 + j;
    sm.cls[j] = a.cls[m];
    sm.qp[j] = a.qp[m];
    sm.cbp[j] = a.cbp_luma[m];
    sm.cbpc[j] = a.cbp_chroma[m];
    sm.t8[j] = a.t8[m];
  } else if (tid >= 64 && tid < 64 + 56) {
    // 6 x 4 chunks of w4, then 2 x 16 of w8
    const int c = tid - 64;
    int4* dst = c < 24 ? reinterpret_cast<int4*>(sm.w4[c >> 2]) + (c & 3)
                       : reinterpret_cast<int4*>(sm.w8[(c - 24) >> 4])
                             + ((c - 24) & 15);
    *dst = !a.use_scaling ? make_int4(16, 16, 16, 16)
         : c < 24 ? reinterpret_cast<const int4*>(a.w4[c >> 2])[c & 3]
                  : reinterpret_cast<const int4*>(a.w8[(c - 24) >> 4])
                        [(c - 24) & 15];
  }
}

// the levels and PCM samples the run's MBs read (one cp.async group)
__device__ void stage_levels(const Args& a, Smem& sm, int m0, int nmb,
                             int tid) {
  const int64_t m0l = m0;
  // luma_ac: 16 blocks of 2 chunks a MB, on the 4x4 path where the block
  // is coded or the MB is I16
  for (int c = tid; c < nmb * 32; c += THREADS) {
    const int j = c >> 5, k = (c >> 1) & 15;
    const int b8 = (k >> 3) * 2 + ((k >> 1) & 1);
    if (!path8(sm, j) && (sm.cls[j] == 1 || ((sm.cbp[j] >> b8) & 1)))
      tx::cp_async<16>(&sm.luma_ac[0][0] + c * 8, a.luma_ac + m0l * 256 + c * 8);
  }
  // luma8: 4 blocks of 8 chunks a MB, on the 8x8 path where coded
  if (a.luma8 != nullptr)
    for (int c = tid; c < nmb * 32; c += THREADS) {
      const int j = c >> 5, b8 = (c >> 3) & 3;
      if (path8(sm, j) && ((sm.cbp[j] >> b8) & 1))
        tx::cp_async<16>(&sm.luma8[0][0] + c * 8, a.luma8 + m0l * 256 + c * 8);
    }
  // chroma_ac: 16 chunks a MB with cbp_chroma == 2
  for (int c = tid; c < nmb * 16; c += THREADS)
    if (sm.cbpc[c >> 4] == 2)
      tx::cp_async<16>(&sm.chroma_ac[0][0] + c * 8,
                     a.chroma_ac + m0l * 128 + c * 8);
  // luma_dc (2 chunks) on I16 MBs, chroma_dc (1) with cbp_chroma != 0
  if (tid < nmb * 2 && sm.cls[tid >> 1] == 1)
    tx::cp_async<16>(&sm.luma_dc[0][0] + tid * 8, a.luma_dc + m0l * 16
                                                    + tid * 8);
  if (tid >= 32 && tid < 32 + nmb && sm.cbpc[tid - 32] != 0)
    tx::cp_async<16>(sm.chroma_dc[tid - 32], a.chroma_dc + (m0l + tid - 32)
                                                          * 8);
  // pcm: 24 chunks a PCM MB
  if (a.pcm != nullptr)
    for (int c = tid; c < nmb * 24; c += THREADS)
      if (sm.cls[c / 24] == 8)
        tx::cp_async<16>(&sm.pcm[0][0] + c * 16, a.pcm + m0l * 384 + c * 16);
}

// the prediction rows of the run's MBs of kind 1 (one cp.async group):
// luma 16 rows of 4 chunks a MB, chroma 8 rows of 2
__device__ void stage_pred(const Args& a, Smem& sm, int mby, int mbx0,
                           int nmb, int tid) {
  if (a.pred[0] == nullptr) return;
  const int W = a.mb_w * 16;
  for (int c = tid; c < 16 * RUN * 4; c += THREADS) {
    const int r = c / (RUN * 4), x4 = c % (RUN * 4), j = x4 >> 2;
    if (j < nmb && kind_of(a, sm, j) == 1)
      tx::cp_async<16>(&sm.pred_y[r][x4 * 4],
                     a.pred[0] + static_cast<int64_t>(mby * 16 + r) * W
                         + mbx0 * 16 + x4 * 4);
  }
  for (int c = tid; c < 2 * 8 * RUN * 2; c += THREADS) {
    const int p = c / (8 * RUN * 2), r = (c / (RUN * 2)) & 7;
    const int x4 = c % (RUN * 2), j = x4 >> 1;
    if (j < nmb && kind_of(a, sm, j) == 1)
      tx::cp_async<16>(&sm.pred_c[p][r][x4 * 4],
                     a.pred[1 + p] + static_cast<int64_t>(mby * 8 + r)
                                         * (W / 2)
                         + mbx0 * 8 + x4 * 4);
  }
}

// ---- phase 2: the transforms ----

// a qp's dequant scale of each 4x4 position class, read once a lane
struct Deq4 {
  u32 v[3];
};

__device__ __forceinline__ Deq4 deq4(int qp) {
  Deq4 d;
#pragma unroll
  for (int c = 0; c < 3; ++c) d.v[c] = static_cast<u32>(tx::V4[qp % 6][c]);
  return d;
}

// the luma of MB j on the 8x8 path, a warp: lane = 8 * b8 + i, row i and
// then column i of the 8x8 block b8, through the MB's residual tile
__device__ void luma8x8(const Args& a, Smem& sm, int j, int lane) {
  const int b8 = lane >> 3, i = lane & 7;
  const int qp = sm.qp[j];
  const bool coded = ((sm.cbp[j] >> b8) & 1) && a.luma8 != nullptr;
  int32_t* blk = sm.res_y[j] + (b8 >> 1) * 128 + (b8 & 1) * 8;
  u32 w[8];
  if (coded) {
    const int16_t* c = sm.luma8[j] + b8 * 64 + i * 8;
    const int32_t* wm = sm.w8[sm.cls[j] <= 2 ? 0 : 1] + i * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      w[k] = tx::dequant(static_cast<u32>(c[k]), static_cast<u32>(wm[k]),
                         static_cast<u32>(tx::V8[qp % 6][tx::POS8[i * 8 + k]]),
                         qp / 6, 6);
    tx::inv8(w, 1);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = 0u;
  }
  *reinterpret_cast<int4*>(blk + i * 16) = make_int4(
      tx::s32(w[0]), tx::s32(w[1]), tx::s32(w[2]), tx::s32(w[3]));
  *reinterpret_cast<int4*>(blk + i * 16 + 4) = make_int4(
      tx::s32(w[4]), tx::s32(w[5]), tx::s32(w[6]), tx::s32(w[7]));
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 8; ++r) w[r] = static_cast<u32>(blk[r * 16 + i]);
  tx::inv8(w, 1);
#pragma unroll
  for (int r = 0; r < 8; ++r) blk[r * 16 + i] = tx::s32(tx::sra(w[r] + 32u, 6));
}

// luma block k (raster) of MB j on the 4x4 path, a lane (j < 0: no MB,
// the lane only passes the warp's barrier)
__device__ void luma4x4(Smem& sm, int j, int k) {
  const int by = k >> 2, bx = k & 3;
  const bool i16 = j >= 0 && sm.cls[j] == 1;
  if (i16) {
    // hadamard4x4's rows: at (by, bx) the sum over c of H[bx][c] dc[by][c]
    const int16_t* dc = sm.luma_dc[j] + by * 4;
    u32 t = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const u32 v = static_cast<u32>(dc[c]);
      t = hneg(bx, c) ? t - v : t + v;
    }
    sm.had[j][k] = t;
  }
  __syncwarp();
  if (j < 0) return;
  const int cls = sm.cls[j], qp = sm.qp[j];
  const int b8 = (by >> 1) * 2 + (bx >> 1);
  u32 w[16];
  if (((sm.cbp[j] >> b8) & 1) || i16) {
    const int32_t* wm = sm.w4[cls <= 2 ? 0 : 3];
    const int16_t* c = sm.luma_ac[j] + k * 16;
    const Deq4 dq = deq4(qp);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i] = tx::dequant(static_cast<u32>(c[i]), static_cast<u32>(wm[i]),
                         dq.v[tx::pos4(i)], qp / 6, 4);
    if (i16) {
      // and its columns: the sum over r of H[by][r] had[r][bx], then the
      // DC dequant with the intra matrix's DC weight
      u32 t = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const u32 v = sm.had[j][r * 4 + bx];
        t = hneg(by, r) ? t - v : t + v;
      }
      w[0] = tx::luma_dc_dequant(t, static_cast<u32>(sm.w4[0][0]), qp);
    }
    tx::idct4x4(w);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = 0u;
  }
  int32_t* tile = sm.res_y[j] + by * 64 + bx * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) store4(tile + r * 16, w, 4 * r);
}

// chroma block k (raster in the 8x8) of plane c (0 U, 1 V) of MB j, a
// lane: AC levels only with cbp_chroma == 2, the dequantized 2x2 DC
// transform in position 0 with cbp_chroma != 0, 0 without either
__device__ void chroma4x4(const Args& a, Smem& sm, int j, int c, int k) {
  const int cbp = sm.cbpc[j];
  u32 w[16];
  if (cbp != 0) {
    int q = sm.qp[j] + a.cqp_off[c];
    q = tx::CHROMA_QP[q < 0 ? 0 : q > 51 ? 51 : q];
    const int32_t* wm = sm.w4[sm.cls[j] <= 2 ? 1 + c : 4 + c];
    const int16_t* ac = sm.chroma_ac[j] + (c * 4 + k) * 16;
    const Deq4 dq = deq4(q);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i] = cbp == 2 ? tx::dequant(static_cast<u32>(ac[i]),
                                    static_cast<u32>(wm[i]),
                                    dq.v[tx::pos4(i)], q / 6, 4)
                      : 0u;
    const int16_t* dc = sm.chroma_dc[j] + c * 4;
    const u32 t = tx::had2_at(static_cast<u32>(dc[0]), static_cast<u32>(dc[1]),
                              static_cast<u32>(dc[2]), static_cast<u32>(dc[3]),
                              k);
    w[0] = tx::chroma_dc_dequant(t, static_cast<u32>(wm[0]), q);
    tx::idct4x4(w);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = 0u;
  }
  int32_t* tile = sm.res_c[c][j] + (k >> 1) * 32 + (k & 1) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) store4(tile + r * 8, w, 4 * r);
}

// ---- phase 3: the stores ----

// the working plane p (T = 16 luma, 8 chroma) over the run's columns and
// rows, with the WPAD border where the run touches the picture's edge, as
// 16-byte chunks of consecutive threads
template <int T>
__device__ void store_plane(const Args& a, const Smem& sm, int p, int mby,
                            int mbx0, int nmb, int tid) {
  constexpr int CH = T / 4;          // 16-byte chunks per MB row
  const int y_lo = mby == 0 ? -WPAD : 0;
  const int y_hi = mby == a.mb_h - 1 ? T + WPAD : T;
  const int x_lo = mbx0 == 0 ? -WPAD / 4 : 0;
  const int x_hi = nmb * CH + (mbx0 + nmb == a.mb_w ? WPAD / 4 : 0);
  const int cpr = x_hi - x_lo;
  const int fw = a.mb_w * T + 2 * WPAD;
  int32_t* out = a.plane[p] + static_cast<int64_t>(mby * T + WPAD) * fw
                 + mbx0 * T + WPAD;
  const bool has_pred = a.pred[p] != nullptr;
  for (int f = tid; f < (y_hi - y_lo) * cpr; f += THREADS) {
    const int y = y_lo + f / cpr, x4 = x_lo + f % cpr;
    int4 v = make_int4(0, 0, 0, 0);
    if (y >= 0 && y < T && x4 >= 0 && x4 < nmb * CH) {
      const int j = x4 / CH, col = (x4 % CH) * 4;
      if (sm.kind[j] == 2) {
        const uint8_t* s = sm.pcm[j] + (p == 0 ? 0 : 192 + 64 * p) + y * T
                           + col;
        v = make_int4(s[0], s[1], s[2], s[3]);
      } else if (sm.kind[j] == 1) {
        const int4 r = *reinterpret_cast<const int4*>(
            (p == 0 ? sm.res_y[j] : sm.res_c[p - 1][j]) + y * T + col);
        const int4 q = has_pred ? *reinterpret_cast<const int4*>(
                           p == 0 ? &sm.pred_y[y][x4 * 4]
                                  : &sm.pred_c[p - 1][y][x4 * 4])
                                : make_int4(0, 0, 0, 0);
        v = make_int4(
            tx::clip255(static_cast<u32>(q.x) + static_cast<u32>(r.x)),
            tx::clip255(static_cast<u32>(q.y) + static_cast<u32>(r.y)),
            tx::clip255(static_cast<u32>(q.z) + static_cast<u32>(r.z)),
            tx::clip255(static_cast<u32>(q.w) + static_cast<u32>(r.w)));
      }
    }
    *reinterpret_cast<int4*>(out + static_cast<int64_t>(y) * fw + x4 * 4) = v;
  }
}

// a residual plane's tiles of the run, contiguous in res_*
__device__ __forceinline__ void store_tiles(int32_t* dst, const int32_t* src,
                                            int chunks, int tid) {
  for (int c = tid; c < chunks; c += THREADS)
    reinterpret_cast<int4*>(dst)[c] = reinterpret_cast<const int4*>(src)[c];
}

__global__ void __launch_bounds__(THREADS) residual_dec(const Args a) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mby = blockIdx.y, mbx0 = blockIdx.x * RUN;
  const int nmb = min(RUN, a.mb_w - mbx0);
  const int m0 = mby * a.mb_w + mbx0;

  stage_mbs(a, sm, m0, nmb, tid);
  __syncthreads();
  stage_levels(a, sm, m0, nmb, tid);
  tx::cp_async_commit();
  stage_pred(a, sm, mby, mbx0, nmb, tid);
  tx::cp_async_commit();
  if (tid < nmb) sm.kind[tid] = kind_of(a, sm, tid);
  if (tid == 0) {
    int n8 = 0;
    for (int j = 0; j < nmb; ++j)
      if (path8(sm, j)) sm.ord[n8++] = j;
    sm.n8 = n8;
    for (int j = 0, i = n8; j < nmb; ++j)
      if (!path8(sm, j)) sm.ord[i++] = j;
  }
  tx::cp_async_wait<1>();
  __syncthreads();

  // the tasks: an 8x8 MB a warp, then two 4x4 MBs, then four MBs' chroma
  const int n8 = sm.n8, t4 = (nmb - n8 + 1) / 2;
  for (int t = warp; t < n8 + t4 + (nmb + 3) / 4; t += WARPS) {
    if (t < n8) {
      luma8x8(a, sm, sm.ord[t], lane);
    } else if (t < n8 + t4) {
      const int i = n8 + 2 * (t - n8) + (lane >> 4);
      luma4x4(sm, i < nmb ? sm.ord[i] : -1, lane & 15);
    } else {
      const int j = 4 * (t - n8 - t4) + (lane >> 3);
      if (j < nmb) chroma4x4(a, sm, j, (lane >> 2) & 1, lane & 3);
    }
  }
  tx::cp_async_wait<0>();
  __syncthreads();

  store_tiles(a.res[0] + static_cast<int64_t>(m0) * 256, sm.res_y[0],
              nmb * 64, tid);
  store_tiles(a.res[1] + static_cast<int64_t>(m0) * 64, sm.res_c[0][0],
              nmb * 16, tid);
  store_tiles(a.res[2] + static_cast<int64_t>(m0) * 64, sm.res_c[1][0],
              nmb * 16, tid);
  store_plane<16>(a, sm, 0, mby, mbx0, nmb, tid);
  store_plane<8>(a, sm, 1, mby, mbx0, nmb, tid);
  store_plane<8>(a, sm, 2, mby, mbx0, nmb, tid);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// One frame: the residual tiles and the padded working planes (see the
// top of this file). Pointers may be null where the frame has no luma8,
// no pcm or no prediction plane. Returns cudaErrorMisalignedAddress
// without a launch when a buffer does not start on 16 bytes, else
// cudaGetLastError() after the launch.
extern "C" int pip_residual_dec(
    const uint8_t* cls, const uint8_t* qp, const uint8_t* cbp_luma,
    const uint8_t* cbp_chroma, const uint8_t* t8, const int16_t* luma_ac,
    const int16_t* luma_dc, const int16_t* luma8, const int16_t* chroma_ac,
    const int16_t* chroma_dc, const int32_t* ref_slot, const uint8_t* pcm,
    const int32_t* w4_0, const int32_t* w4_1, const int32_t* w4_2,
    const int32_t* w4_3, const int32_t* w4_4, const int32_t* w4_5,
    const int32_t* w8_0, const int32_t* w8_1, int use_scaling,
    int cqp_off_u, int cqp_off_v, const int32_t* pred_y,
    const int32_t* pred_u, const int32_t* pred_v, int32_t* Yw, int32_t* Uw,
    int32_t* Vw, int32_t* res_y, int32_t* res_u, int32_t* res_v, int mb_w,
    int mb_h, cudaStream_t stream) {
  const Args a = {cls, qp, cbp_luma, cbp_chroma, t8, luma_ac, luma_dc,
                  luma8, chroma_ac, chroma_dc, ref_slot, pcm,
                  {w4_0, w4_1, w4_2, w4_3, w4_4, w4_5}, {w8_0, w8_1},
                  {pred_y, pred_u, pred_v}, {Yw, Uw, Vw},
                  {res_y, res_u, res_v}, use_scaling, {cqp_off_u, cqp_off_v},
                  mb_w, mb_h};
  const void* vec[] = {luma_ac, luma_dc, luma8, chroma_ac, chroma_dc,
                       ref_slot, pcm, w4_0, w4_1, w4_2, w4_3, w4_4, w4_5,
                       w8_0, w8_1, pred_y, pred_u, pred_v, Yw, Uw, Vw,
                       res_y, res_u, res_v};
  for (const void* p : vec)
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((mb_w + RUN - 1) / RUN, mb_h);
  residual_dec<<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
