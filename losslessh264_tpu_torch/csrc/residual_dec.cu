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
// Each thread owns one 4x4 block of one MB: blocks 0-15 the luma blocks
// (raster in the MB), 16-19 the U and 20-23 the V blocks (raster in the
// 8x8). A luma thread of an MB that is not I16 and has transform8 set
// computes its 8x8 block's dequant and 8x8 inverse transform whole and
// keeps its quadrant; an I16 thread computes its own DC from the 16 DC
// levels (the inverse Hadamard's output at its position) and the DC
// dequant; a chroma thread its DC from the plane's 4 DC levels. So a
// thread computes only the path its MB takes, and no thread waits for
// another. It writes its 4x4 of the residual tile (res_y [n,16,16], res_u
// and res_v [n,8,8], which the intra pass K3 reads) and of the working
// plane: the PCM samples on a PCM MB when the frame has them, else
// clip(pred + res, 0, 255) on an MB whose 16 ref_slot cells are all >= 0
// (pred 0 when the frame has no prediction), else 0. Threads past the MBs'
// CTAs write the WPAD = 8 zero border of the three int32 planes.
//
// The inputs are the symbol layer's buffers as the decoder uploads them
// (decoder_torch.planes_to_torch): uint8 mb_class, qp, cbp_luma,
// cbp_chroma and transform8 [n]; int16 luma_ac [n,16,4,4], luma_dc
// [n,4,4], luma8 [n,4,8,8] (absent: null, read as 0), chroma_ac
// [n,8,4,4], chroma_dc [n,2,2,2]; int32 ref_slot [n,16]; uint8 pcm [n,384]
// (absent: null); the six int32 [4,4] and two [8,8] weight matrices (read
// only with use_scaling, else flat 16). The wrapper checks each.
//
// What bounds it on the H100: bytes. At 720p it reads the coefficient
// planes (1.84 MB luma_ac, 0.92 chroma_ac, 1.84 luma8 where present, the
// small planes), ref_slot (0.23 MB) and the int32 prediction planes (5.5
// MB), and writes the padded planes (5.8 MB) and the residual tiles (5.5
// MB): ~20-23 MB, ~0.006-0.007 ms at 3.35 TB/s. The integer work is ~100
// operations per sample, ~0.004 ms at the int32 rate. What the design does:
// one launch, one thread per 4x4 block, no barrier, no shared memory;
// each thread's stores are 16-byte rows; the per-MB scalars and ref_slot
// row are read by the 24 threads of an MB through L1.
#include <cuda_runtime.h>
#include <stdint.h>

#include "transform.cuh"

namespace {

using tx::u32;

constexpr int WPAD = 8;
constexpr int ITEMS = 24;            // 4x4 blocks per MB
constexpr int MBS = 8;               // MBs per CTA
constexpr int THREADS = MBS * ITEMS;

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

__device__ __forceinline__ void store4(int32_t* p, const int32_t (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// whether H[r][j] is -1 in the 4-point Hadamard H of hadamard4x4 (rows
// ++++, ++--, +--+, +-+-: row r's sign bits at 4r..4r+3)
__device__ __forceinline__ bool hneg(int r, int j) {
  return (0xA6C0 >> (4 * r + j)) & 1;
}

// the residual of luma block k (raster) of MB m
__device__ void luma_res(const Args& a, int m, int k, int cls, int qp,
                         int32_t (&res)[16]) {
  const bool i16 = cls == 1, intra = cls <= 2;
  const int cbp = a.cbp_luma[m];
  const int by = k >> 2, bx = k & 3;
  const int b8 = (by >> 1) * 2 + (bx >> 1);
  const int32_t* wm;
  if (a.t8[m] != 0 && !i16) {
    // the 8x8 block b8, whole; this thread keeps its quadrant
    u32 w[64];
    const bool coded = ((cbp >> b8) & 1) && a.luma8 != nullptr;
    wm = a.use_scaling ? a.w8[intra ? 0 : 1] : nullptr;
    const int16_t* c = a.luma8 + (static_cast<int64_t>(m) * 4 + b8) * 64;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      w[i] = coded ? tx::dequant(static_cast<u32>(c[i]),
                                 wm ? static_cast<u32>(wm[i]) : 16u,
                                 static_cast<u32>(tx::V8[qp % 6][tx::POS8[i]]),
                                 qp / 6, 6)
                   : 0u;
    }
    tx::idct8x8(w);
    // the quadrant by selects, not by a run-time index, so that w stays
    // in registers
    const bool lo = by & 1, right = bx & 1;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c2 = 0; c2 < 4; ++c2) {
        const u32 top = right ? w[r * 8 + 4 + c2] : w[r * 8 + c2];
        const u32 bot = right ? w[(r + 4) * 8 + 4 + c2] : w[(r + 4) * 8 + c2];
        res[4 * r + c2] = coded ? tx::s32(lo ? bot : top) : 0;
      }
    return;
  }
  if (!(((cbp >> b8) & 1) || i16)) {
#pragma unroll
    for (int i = 0; i < 16; ++i) res[i] = 0;
    return;
  }
  u32 w[16];
  wm = a.use_scaling ? a.w4[intra ? 0 : 3] : nullptr;
  const int16_t* c = a.luma_ac + (static_cast<int64_t>(m) * 16 + k) * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = tx::dequant(static_cast<u32>(c[i]),
                       wm ? static_cast<u32>(wm[i]) : 16u,
                       static_cast<u32>(tx::V4[qp % 6][tx::POS4[i]]), qp / 6,
                       4);
  if (i16) {
    // output (by, bx) of the inverse 4x4 Hadamard of the DC levels
    // (hadamard4x4: sum over (i, j) of H[by][i] H[bx][j] dc[i][j], H the
    // rows ++++, ++--, +--+, +-+-), then its dequant with the intra
    // matrix's DC weight
    const int16_t* dc = a.luma_dc + static_cast<int64_t>(m) * 16;
    u32 t = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const u32 v = static_cast<u32>(dc[i]);
      t = hneg(by, i >> 2) != hneg(bx, i & 3) ? t - v : t + v;
    }
    const u32 w00 = a.use_scaling ? static_cast<u32>(a.w4[0][0]) : 16u;
    w[0] = tx::luma_dc_dequant(t, w00, qp);
  }
  tx::idct4x4(w);
#pragma unroll
  for (int i = 0; i < 16; ++i) res[i] = tx::s32(w[i]);
}

// the residual of chroma block k (raster in the 8x8) of plane c (0 U,
// 1 V) of MB m: AC levels only with cbp_chroma == 2, the dequantized 2x2
// DC transform in position 0 with cbp_chroma != 0, 0 without either
__device__ void chroma_res(const Args& a, int m, int c, int k, int cls,
                           int qp, int32_t (&res)[16]) {
  const int cbp = a.cbp_chroma[m];
  if (cbp == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) res[i] = 0;
    return;
  }
  const bool intra = cls <= 2;
  int q = qp + a.cqp_off[c];
  q = tx::CHROMA_QP[q < 0 ? 0 : q > 51 ? 51 : q];
  const int32_t* wm =
      a.use_scaling ? a.w4[intra ? 1 + c : 4 + c] : nullptr;
  const int16_t* ac = a.chroma_ac + (static_cast<int64_t>(m) * 8 + c * 4 + k)
                                        * 16;
  u32 w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = cbp == 2 ? tx::dequant(static_cast<u32>(ac[i]),
                                  wm ? static_cast<u32>(wm[i]) : 16u,
                                  static_cast<u32>(tx::V4[q % 6][tx::POS4[i]]),
                                  q / 6, 4)
                    : 0u;
  const int16_t* dc = a.chroma_dc + static_cast<int64_t>(m) * 8 + c * 4;
  const u32 t = tx::had2_at(static_cast<u32>(dc[0]), static_cast<u32>(dc[1]),
                            static_cast<u32>(dc[2]), static_cast<u32>(dc[3]),
                            k);
  w[0] = tx::chroma_dc_dequant(t, wm ? static_cast<u32>(wm[0]) : 16u, q);
  tx::idct4x4(w);
#pragma unroll
  for (int i = 0; i < 16; ++i) res[i] = tx::s32(w[i]);
}

// zero one element of the WPAD border of the three working planes: index
// e runs over Y's border, then U's, then V's; a border is 8 full rows
// above, 8 below and 8 columns on either side of each picture row
__device__ void zero_border(const Args& a, int64_t e) {
  const int H = a.mb_h * 16, W = a.mb_w * 16;
  for (int p = 0; p < 3; ++p) {
    const int h = p ? H / 2 : H, w = p ? W / 2 : W;
    const int fw = w + 2 * WPAD;
    const int64_t size = static_cast<int64_t>(2 * WPAD) * fw
                         + static_cast<int64_t>(h) * 2 * WPAD;
    if (e >= size) {
      e -= size;
      continue;
    }
    int row, col;
    if (e < static_cast<int64_t>(WPAD) * fw) {
      row = static_cast<int>(e / fw);
      col = static_cast<int>(e % fw);
    } else if (e < static_cast<int64_t>(2 * WPAD) * fw) {
      e -= static_cast<int64_t>(WPAD) * fw;
      row = h + WPAD + static_cast<int>(e / fw);
      col = static_cast<int>(e % fw);
    } else {
      e -= static_cast<int64_t>(2 * WPAD) * fw;
      row = WPAD + static_cast<int>(e / (2 * WPAD));
      const int j = static_cast<int>(e % (2 * WPAD));
      col = j < WPAD ? j : w + j;
    }
    a.plane[p][static_cast<int64_t>(row) * fw + col] = 0;
    return;
  }
}

__global__ void __launch_bounds__(THREADS)
    residual_dec(const Args a, int mb_ctas) {
  if (static_cast<int>(blockIdx.x) >= mb_ctas) {
    zero_border(a, static_cast<int64_t>(blockIdx.x - mb_ctas) * THREADS
                       + threadIdx.x);
    return;
  }
  const int m = blockIdx.x * MBS + threadIdx.x / ITEMS;
  const int item = threadIdx.x % ITEMS;
  if (m >= a.mb_w * a.mb_h) return;
  const int cls = a.cls[m], qp = a.qp[m];
  bool inter = true;
  const int32_t* rs = a.ref_slot + static_cast<int64_t>(m) * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) inter = inter && rs[i] >= 0;
  const bool pcm = a.pcm != nullptr && cls == 8;

  // the block's plane p, its size t (16 luma, 8 chroma) and its place
  const int p = item < 16 ? 0 : item < 20 ? 1 : 2;
  const int k = item < 16 ? item : (item - 16) & 3;
  const int t = p ? 8 : 16;
  const int by = p ? k >> 1 : k >> 2, bx = p ? k & 1 : k & 3;
  int32_t res[16];
  if (p == 0)
    luma_res(a, m, k, cls, qp, res);
  else
    chroma_res(a, m, p - 1, k, cls, qp, res);

  const int mbx = m % a.mb_w, mby = m / a.mb_w;
  const int w = a.mb_w * t;                   // the picture's width
  const int fw = w + 2 * WPAD;
  int32_t* tile = a.res[p] + static_cast<int64_t>(m) * t * t
                  + by * 4 * t + bx * 4;
  const int y0 = mby * t + by * 4, x0 = mbx * t + bx * 4;
  int32_t* out = a.plane[p] + static_cast<int64_t>(y0 + WPAD) * fw + x0
                 + WPAD;
  const int32_t* pred = a.pred[p] ? a.pred[p] + static_cast<int64_t>(y0) * w
                                        + x0
                                  : nullptr;
  const uint8_t* pc = pcm ? a.pcm + static_cast<int64_t>(m) * 384
                                + (p == 0 ? 0 : p == 1 ? 256 : 320)
                                + by * 4 * t + bx * 4
                          : nullptr;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int32_t row[4] = {res[4 * r], res[4 * r + 1], res[4 * r + 2],
                      res[4 * r + 3]};
    store4(tile + r * t, row);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (pcm)
        row[c] = pc[r * t + c];
      else if (inter)
        row[c] = tx::clip255(static_cast<u32>(pred ? pred[r * w + c] : 0)
                             + static_cast<u32>(row[c]));
      else
        row[c] = 0;
    }
    store4(out + static_cast<int64_t>(r) * fw, row);
  }
}

}  // namespace

// One frame: the residual tiles and the padded working planes (see the
// top of this file). Pointers may be null where the frame has no luma8,
// no pcm or no prediction plane. Returns cudaGetLastError() after the
// launch.
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
  Args a = {cls, qp, cbp_luma, cbp_chroma, t8, luma_ac, luma_dc, luma8,
            chroma_ac, chroma_dc, ref_slot, pcm,
            {w4_0, w4_1, w4_2, w4_3, w4_4, w4_5}, {w8_0, w8_1},
            {pred_y, pred_u, pred_v}, {Yw, Uw, Vw}, {res_y, res_u, res_v},
            use_scaling, {cqp_off_u, cqp_off_v}, mb_w, mb_h};
  const int n = mb_w * mb_h;
  const int64_t H = mb_h * 16, W = mb_w * 16;
  const int64_t border = (2 * WPAD * (W + 2 * WPAD) + H * 2 * WPAD)
                         + 2 * (2 * WPAD * (W / 2 + 2 * WPAD)
                                + H / 2 * 2 * WPAD);
  const int mb_ctas = (n + MBS - 1) / MBS;
  const int ctas = mb_ctas + static_cast<int>((border + THREADS - 1)
                                              / THREADS);
  residual_dec<<<ctas, THREADS, 0, stream>>>(a, mb_ctas);
  return static_cast<int>(cudaGetLastError());
}
