// K11: the decoder's per-cell motion compensation of one P frame, the
// route of every frame the bucketed plan (K6) does not serve: frames whose
// distinct (slot, mv) triples spill past the plan's caps, and every frame
// with explicit weighted prediction (WP).
//
// Replaces the chain of torch ops of decoder_torch._mc_legacy_cells (a
// port of losslessh264_tpu/decoder_jax.py:168, the general gather path):
// the batched window gathers of ops/mc.mc_luma_cells and mc_chroma_cells,
// the explicit WP after them and the permutes of _tiles_to_plane. Plain
// version: cases.k11_plain (_mc_legacy_cells' planes, 0 on
// the intra cells); wrapper ops/mc.mc_cells, one launch per frame and no
// host op around it.
//
// Every 4x4 cell c = 16 * MB + cell (raster MBs, raster cells in the MB)
// whose ref_slot (int32 [n, 16]) is 0 or more is predicted from the raw
// uint8 rings as mc_luma_cells and mc_chroma_cells predict it (the code K6
// runs for its fix-up cells, csrc/mc_cell.cuh): its slot clamped to the
// ring, its MV (int16 [n, 16, 2], x then y) clipped as iFullMV is
// clipped, quarter-pel 6-tap luma and eighth-pel bilinear U and V. With
// WP (the four planes present), as decoder_torch._weighted:
//   luma:   per cell, (w, o, d) = wp_luma[c] (int16 [n, 16, 3]);
//   chroma: per chroma sample whose wp_cmask byte (uint8 [n, 8, 8]) is
//           not 0, (w, o, d) of its cell in wp_cb / wp_cr, the cell of
//           chroma sample (r, c) of an MB being (r / 2) * 4 + c / 2; the
//           reference decoder weights only that region (rec_mb.cpp
//           WeightPrediction);
//   weighted: d < 0 leaves the sample, d = 0 gives clip(p w + o), d >= 1
//           clip(((p w + 2^(d-1)) >> d) + o).
// A cell whose ref_slot is below 0 (an intra MB's) is 0: K7 reads the
// prediction of MBs whose 16 cells are all 0 or more, nothing else.
// The three int32 planes are written in plane layout ([16 mb_h, 16 mb_w],
// [8 mb_h, 8 mb_w] twice), each sample once.
//
// What bounds it on the H100: bytes, and they are few. At 640x352 the
// function depends on ref_slot and mv (113 KB), ~1 luma sample per pixel
// of the inter cells' windows (a sample that neighbouring cells' windows
// share counted once) and ~1 chroma sample per chroma pixel and plane, and
// writes three int32 planes (1.35 MB): ~1.8 MB, ~0.0005 ms at 3.35 TB/s
// (bench_port/harness/workcounts_cells.py counts them). At that size the
// launch and one wave of CTAs set the time. What the design does:
// - one launch per frame: a thread owns one 4x4 cell, reads its ref_slot,
//   MV and WP in place from the plane dict's device tensors, and writes its
//   4 luma rows as 16-byte stores and its 2 chroma rows per plane as 8-byte
//   stores; neighbouring threads own neighbouring cells of a cell row, so
//   the plan's loads, the window rows and the stores are coalesced.
// - no shared memory and no barrier: a cell depends on nothing but its own
//   inputs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_cell.cuh"

namespace {

constexpr int THREADS = 128;

using mcc::clip255;
using mcc::Rings;

// The WP planes as the decoder uploads them, all null on a frame without
// WP: wp_luma, wp_cb, wp_cr int16 [n, 16, 3] (w, o, d per cell) and
// wp_cmask uint8 [n, 8, 8].
struct Weights {
  const int16_t* luma;
  const int16_t* cb;
  const int16_t* cr;
  const uint8_t* cmask;
};

// decoder_torch._weighted of one sample
__device__ __forceinline__ int weighted(int p, int w, int o, int d) {
  if (d < 0) return p;
  return clip255(d >= 1 ? ((p * w + (1 << (d - 1))) >> d) + o : p * w + o);
}

__global__ void __launch_bounds__(THREADS)
mc_cells_kernel(const int32_t* __restrict__ ref_slot,
                const int16_t* __restrict__ mv, const Weights wp,
                const Rings rg, int mb_w, int mb_h, int pad,
                int32_t* __restrict__ pred_y, int32_t* __restrict__ pred_u,
                int32_t* __restrict__ pred_v) {
  const int cw = 4 * mb_w;                      // cells in a cell row
  const int at = blockIdx.x * THREADS + threadIdx.x;
  if (at >= cw * 4 * mb_h) return;
  const int cr = at / cw, cc = at % cw;         // cell row and column
  const int mb = (cr >> 2) * mb_w + (cc >> 2);
  const int k = (cr & 3) * 4 + (cc & 3);        // the cell in its MB
  const int cell = mb * 16 + k;                 // the plan's index
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  int4* oy = reinterpret_cast<int4*>(pred_y + (size_t)(4 * cr) * W + 4 * cc);
  int2* ou = reinterpret_cast<int2*>(pred_u + (size_t)(2 * cr) * Wc + 2 * cc);
  int2* ov = reinterpret_cast<int2*>(pred_v + (size_t)(2 * cr) * Wc + 2 * cc);

  const int raw = ref_slot[cell];
  if (raw < 0) {
    const int4 z4 = make_int4(0, 0, 0, 0);
    const int2 z2 = make_int2(0, 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) oy[r * (W / 4)] = z4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ou[r * (Wc / 2)] = z2;
      ov[r * (Wc / 2)] = z2;
    }
    return;
  }
  const int slot = min(raw, rg.R - 1);
  const int vx = mv[2 * cell], vy = mv[2 * cell + 1];

  int out[4][4];
  mcc::cell_luma(rg, rg.y + (size_t)slot * rg.y_slot, pad, 4 * cr, 4 * cc,
                 vx, vy, out);
  if (wp.luma != nullptr) {
    const int16_t* q = wp.luma + 3 * cell;
    const int w = q[0], o = q[1], d = q[2];
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) out[y][x] = weighted(out[y][x], w, o, d);
  }
#pragma unroll
  for (int y = 0; y < 4; ++y)
    oy[y * (W / 4)] = make_int4(out[y][0], out[y][1], out[y][2], out[y][3]);

  int cu[2][2], cv[2][2];
  mcc::cell_chroma(rg, slot, pad / 2, 2 * cr, 2 * cc, vx, vy, cu, cv);
  if (wp.luma != nullptr) {
    const int16_t* qu = wp.cb + 3 * cell;
    const int16_t* qv = wp.cr + 3 * cell;
    // the cell's 2x2 chroma samples: MB rows 2 (k / 4) + r, columns
    // 2 (k % 4) + c of the MB's 8x8 mask
    const uint8_t* m = wp.cmask + mb * 64 + (k >> 2) * 16 + (k & 3) * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (m[r * 8 + c]) {
          cu[r][c] = weighted(cu[r][c], qu[0], qu[1], qu[2]);
          cv[r][c] = weighted(cv[r][c], qv[0], qv[1], qv[2]);
        }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ou[r * (Wc / 2)] = make_int2(cu[r][0], cu[r][1]);
    ov[r * (Wc / 2)] = make_int2(cv[r][0], cv[r][1]);
  }
}

}  // namespace

// ref_slot: device int32 [mb_w * mb_h, 16]; mv: int16 [mb_w * mb_h, 16, 2];
// wp_luma, wp_cb, wp_cr: int16 [mb_w * mb_h, 16, 3] and wp_cmask: uint8
// [mb_w * mb_h, 8, 8], all four or none (null); contiguous. ring_y: uint8
// [R, Hp, Wp], ring_u / ring_v: uint8 [R, Hcp, Wcp], unit column stride,
// slot and row strides in bytes. pred_y: int32 [16 mb_h, 16 mb_w]; pred_u
// / pred_v: int32 [8 mb_h, 8 mb_w], contiguous, 16-byte aligned.
extern "C" int pip_mc_cells(
    const void* ref_slot, const void* mv, const void* wp_luma,
    const void* wp_cb, const void* wp_cr, const void* wp_cmask,
    const void* ring_y, long long y_slot, int y_pitch, int Hp, int Wp,
    const void* ring_u, const void* ring_v, long long c_slot, int c_pitch,
    int Hcp, int Wcp, int R, void* pred_y, void* pred_u, void* pred_v,
    int mb_w, int mb_h, int pad, void* stream) {
  const bool any_wp = wp_luma || wp_cb || wp_cr || wp_cmask;
  const bool all_wp = wp_luma && wp_cb && wp_cr && wp_cmask;
  if (mb_w < 1 || mb_h < 1 || R < 1 || pad < 2 || pad % 2 ||
      any_wp != all_wp)
    return (int)cudaErrorInvalidValue;
  const Rings rg = {(const uint8_t*)ring_y, (const uint8_t*)ring_u,
                    (const uint8_t*)ring_v, y_slot, c_slot, y_pitch, c_pitch,
                    Hp, Wp, Hcp, Wcp, R};
  const Weights wp = {(const int16_t*)wp_luma, (const int16_t*)wp_cb,
                      (const int16_t*)wp_cr, (const uint8_t*)wp_cmask};
  const int n_cells = 16 * mb_w * mb_h;
  mc_cells_kernel<<<(n_cells + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const int32_t*)ref_slot, (const int16_t*)mv, wp, rg, mb_w, mb_h, pad,
      (int32_t*)pred_y, (int32_t*)pred_u, (int32_t*)pred_v);
  return (int)cudaGetLastError();
}
