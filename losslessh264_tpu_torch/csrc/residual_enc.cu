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
// A warp owns one MB, 4 MBs to a CTA. Lanes 0-15 own the luma 4x4 blocks
// (raster), lanes 16-19 the U and 20-23 the V blocks (raster in the 8x8;
// block k is quadrant k, so its MV is the quadrant's refined one). The
// MB-wide terms go through shared memory between three CTA barriers:
// - the source's sum (the proxy's rounded mean) and its SAD to the mean
//   (16 partial sums each), so every lane has proxy and use_intra;
// - a chroma plane's 4 unquantized DC coefficients, whose 2x2 Hadamard
//   each chroma lane takes at its own position and quantizes, and the 4
//   quantized terms, whose inverse transform and dequant it takes at its
//   position before its inverse 4x4 transform;
// - each lane's "some level is not 0", for no_res.
// Luma: residual = source - pred_q, fdct, quant with rd_lam, zigzag out,
// dequant (flat 16), idct, clip(pred + rec) out. Chroma: the bilinear
// eighth-pel prediction from the width-concatenated reference of its
// plane, the window start clamped into the plane as mc_chroma_mbs clamps
// it (xoffC is the chosen reference's x offset), then as luma but the AC
// quantized with the DC skipped and the DC path above in position 0.
//
// Inputs: the source planes, uint8 or int32 (src_bytes) with their row
// strides (U and V share one), pred_q int32 [4n, 8, 8], mvq_x / mvq_y
// int32 [4n], best_sad, part, xoffC, qp and qpc int32 [n], the uint8
// concatenated chroma references [Hc, Wc] (contiguous), rd_lam (-1: off).
// Outputs: use_intra and no_res bool [n], part int32 [n], mv8 int32
// [n,4,2], the luma levels in zigzag order int32 [n,16,16], cdc int32
// [n,2,4], cac int32 [n,2,4,16], tile_y int32 [n,16,16], tile_u and
// tile_v int32 [n,8,8].
//
// What bounds it on the H100: bytes, and the integer work beside them.
// At 720p a frame reads the uint8 source (1.38 MB), pred_q (3.7 MB), the
// chroma windows (~0.6 MB of the references) and the per-MB vectors, and
// writes 3.7 MB of luma levels, 0.46 MB of chroma levels and 5.5 MB of
// tiles: ~15-17 MB, ~0.005 ms at 3.35 TB/s; ~60 int32 operations a sample
// of the ~1.5 sample streams (forward, quant, inverse) are ~0.004 ms at
// 33.5 TOP/s. What the design does: one launch for the frame, a lane per
// 4x4 block with the block in registers, shared memory only for the
// MB-wide terms, 16-byte stores of the tiles and levels.
#include <cuda_runtime.h>
#include <stdint.h>

#include "transform.cuh"

namespace {

using tx::u32;

constexpr int MBS = 4;                // MBs (warps) per CTA
constexpr int THREADS = 32 * MBS;
constexpr int CPAD = 16;              // the chroma references' padding

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

struct Smem {
  int32_t sum[MBS][16];    // the luma lanes' source sums
  int32_t sad[MBS][16];    // their SADs to the MB's rounded mean
  int32_t dc[MBS][2][4];   // the chroma blocks' DC coefficients
  int32_t dcq[MBS][2][4];  // the quantized 2x2 transform of them
  int32_t nz[MBS][24];     // a lane has a level that is not 0
};

__device__ __forceinline__ int32_t src_at(const void* p, int bytes,
                                          int64_t i) {
  return bytes == 1 ? static_cast<const uint8_t*>(p)[i]
                    : static_cast<const int32_t*>(p)[i];
}

__device__ __forceinline__ void store4(int32_t* p, int32_t a, int32_t b,
                                       int32_t c, int32_t d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}

__global__ void __launch_bounds__(THREADS) residual_enc(const Args a) {
  __shared__ Smem sm;
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = a.mb_w * a.mb_h;
  const int m = blockIdx.x * MBS + wi;
  const bool live = m < n;
  const int mbx = live ? m % a.mb_w : 0, mby = live ? m / a.mb_w : 0;
  const bool luma = live && lane < 16, chroma = live && lane >= 16
                                               && lane < 24;
  const int c = (lane - 16) >> 2, k = lane & 3;    // a chroma lane's
  const int by = luma ? lane >> 2 : k >> 1, bx = luma ? lane & 3 : k & 1;
  u32 src[16], pred[16], w[16];

  // ---- phase 1: load, the source sums, the forward transforms ----
  if (luma) {
    const int q = (by >> 1) * 2 + (bx >> 1);
    const int32_t* pq = a.pred_q + (static_cast<int64_t>(m) * 4 + q) * 64
                        + (by & 1) * 32 + (bx & 1) * 4;
    const int64_t s0 = static_cast<int64_t>(mby * 16 + by * 4) * a.y_stride
                       + mbx * 16 + bx * 4;
    int32_t sum = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t s = src_at(a.src_y, a.src_bytes,
                                 s0 + static_cast<int64_t>(r) * a.y_stride
                                     + j);
        sum += s;
        src[4 * r + j] = static_cast<u32>(s);
        pred[4 * r + j] = static_cast<u32>(pq[r * 8 + j]);
        w[4 * r + j] = src[4 * r + j] - pred[4 * r + j];
      }
    sm.sum[wi][lane] = sum;
    tx::fdct4x4(w);
  } else if (chroma) {
    // mc_chroma_mbs of quadrant k at size 4: the window's start clamped
    // into the concatenated plane, then the 2x2 bilinear of each sample
    const int mvx = a.mvq_x[4 * m + k], mvy = a.mvq_y[4 * m + k];
    int iy = CPAD + mby * 8 + by * 4 + (mvy >> 3);
    int ix = CPAD + mbx * 8 + bx * 4 + a.xoff_c[m] + (mvx >> 3);
    iy = iy < 0 ? 0 : iy > a.ref_h - 5 ? a.ref_h - 5 : iy;
    ix = ix < 0 ? 0 : ix > a.ref_w - 5 ? a.ref_w - 5 : ix;
    const int fx = mvx & 7, fy = mvy & 7;
    const uint8_t* ref = (c ? a.ref_v : a.ref_u)
                         + static_cast<int64_t>(iy) * a.ref_w + ix;
    const void* sp = c ? a.src_v : a.src_u;
    const int64_t s0 = static_cast<int64_t>(mby * 8 + by * 4) * a.c_stride
                       + mbx * 8 + bx * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int A = ref[r * a.ref_w + j], B = ref[r * a.ref_w + j + 1];
        const int C = ref[(r + 1) * a.ref_w + j];
        const int D = ref[(r + 1) * a.ref_w + j + 1];
        pred[4 * r + j] = static_cast<u32>(
            ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B
             + (8 - fx) * fy * C + fx * fy * D + 32) >> 6);
        src[4 * r + j] = static_cast<u32>(src_at(
            sp, a.src_bytes, s0 + static_cast<int64_t>(r) * a.c_stride + j));
        w[4 * r + j] = src[4 * r + j] - pred[4 * r + j];
      }
    tx::fdct4x4(w);
    sm.dc[wi][c][k] = tx::s32(w[0]);
  }
  __syncthreads();

  // ---- phase 2: the source's SAD to its rounded mean; the chroma DC
  // levels (fhadamard2x2 of the unquantized DC terms, quant_dc2) ----
  const int qp = live ? a.qp[m] : 0, qpc = live ? a.qpc[m] : 0;
  if (luma) {
    int32_t sum = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) sum += sm.sum[wi][i];
    const int32_t mean = (sum + 128) >> 8;
    int32_t sad = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int32_t d = tx::s32(src[i]) - mean;
      sad += d < 0 ? -d : d;
    }
    sm.sad[wi][lane] = sad;
  } else if (chroma) {
    const int32_t* d = sm.dc[wi][c];
    const u32 t = tx::had2_at(static_cast<u32>(d[0]), static_cast<u32>(d[1]),
                              static_cast<u32>(d[2]), static_cast<u32>(d[3]),
                              k);
    sm.dcq[wi][c][k] = tx::s32(tx::quant_dc(t, qpc));
  }
  __syncthreads();

  // ---- phase 3: quantize, the levels out, dequantize, reconstruct ----
  if (live && lane < 4) {
    // use_intra, the partition and its MVs (lane = quadrant)
    int32_t proxy = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) proxy += sm.sad[wi][i];
    const bool intra = a.best_sad[m] > proxy + 2048;
    const int part = intra ? 0 : a.part[m];
    const int src_q = part == 1 ? (lane == 1 ? 2 : lane)
                    : part == 2 ? lane : part == 3 ? lane : 0;
    const bool zero = (part == 1 || part == 2) && lane >= 2;
    a.mv8[8 * m + 2 * lane] = zero ? 0 : a.mvq_x[4 * m + src_q];
    a.mv8[8 * m + 2 * lane + 1] = zero ? 0 : a.mvq_y[4 * m + src_q];
    if (lane == 0) {
      a.use_intra[m] = intra;
      a.part_out[m] = part;
    }
  }
  int nz = 0;
  if (luma || chroma) {
    const int q = luma ? qp : qpc;
    u32 lev[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      lev[i] = tx::quant_inter(w[i], i, q, a.rd_lam);
    if (chroma) lev[0] = 0u;             // skip_dc
#pragma unroll
    for (int i = 0; i < 16; ++i) nz |= lev[i] != 0u;
    int32_t* zz = luma ? a.qac + (static_cast<int64_t>(m) * 16 + lane) * 16
                       : a.cac + ((static_cast<int64_t>(m) * 2 + c) * 4 + k)
                                     * 16;
#pragma unroll
    for (int i = 0; i < 16; i += 4)
      store4(zz + i, tx::s32(lev[tx::zz4(i)]), tx::s32(lev[tx::zz4(i + 1)]),
             tx::s32(lev[tx::zz4(i + 2)]), tx::s32(lev[tx::zz4(i + 3)]));
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i] = tx::dequant(lev[i], 16u,
                         static_cast<u32>(tx::V4[q % 6][tx::POS4[i]]), q / 6,
                         4);
    if (chroma) {
      const int32_t* d = sm.dcq[wi][c];
      const u32 t = tx::had2_at(static_cast<u32>(d[0]),
                                static_cast<u32>(d[1]),
                                static_cast<u32>(d[2]),
                                static_cast<u32>(d[3]), k);
      w[0] = tx::chroma_dc_dequant(t, 16u, qpc);
      a.cdc[(static_cast<int64_t>(m) * 2 + c) * 4 + k] = d[k];
      nz |= d[k] != 0;
    }
    tx::idct4x4(w);
    const int t = luma ? 16 : 8;
    int32_t* tile = (luma ? a.tile_y : c ? a.tile_v : a.tile_u)
                    + static_cast<int64_t>(m) * t * t + by * 4 * t + bx * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      store4(tile + r * t, tx::clip255(pred[4 * r] + w[4 * r]),
             tx::clip255(pred[4 * r + 1] + w[4 * r + 1]),
             tx::clip255(pred[4 * r + 2] + w[4 * r + 2]),
             tx::clip255(pred[4 * r + 3] + w[4 * r + 3]));
    sm.nz[wi][lane] = nz;
  }
  __syncthreads();
  if (live && lane == 0) {
    int any = 0;
#pragma unroll
    for (int i = 0; i < 24; ++i) any |= sm.nz[wi][i];
    a.no_res[m] = !any;
  }
}

}  // namespace

// One frame's residual analysis (see the top of this file). Returns
// cudaGetLastError() after the launch.
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
  const int ctas = (mb_w * mb_h + MBS - 1) / MBS;
  residual_enc<<<ctas, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
