// K6: the decoder's bucketed motion compensation of one P frame.
//
// Replaces mc_bucketed (losslessh264_tpu/ops/mc.py:436-557) but for its
// half-pel planes: the jax.lax.fori_loop over the frame's unique (slot,
// mv) triples (:512) and the per-cell fix-ups after it (:514-557). Plain
// torch version: losslessh264_tpu_torch/ops/mc.py mc_bucketed_plain;
// wrapper ops/mc.mc_bucketed, which runs K1 for the half-pel planes of
// the active slots before this kernel and nothing after it.
//
// The host plan (ops/mc.mc_fast_plan) gives every 4x4 luma cell c =
// 16 * MB + cell (raster MBs, raster cells in the MB) a bucket u (uint8
// [n, 16]) and every bucket an entry e = uniq[u] of 16 int32: e0 the
// active slot (0 or 1), e1, e2 the integer MV (mvy >> 2, mvx >> 2), e3..e8
// the two half-pel taps (plane, dy, dx) of QTAB, e9, e10 the chroma
// integer MV (mv >> 3), e11, e12 the chroma fraction (mvy & 7, mvx & 7).
// It also lists, ascending in mc_fix (int32 [512], padded with -1), the
// cells the table cannot serve: the reference's iFullMV clip engages, an
// MV is longer than MC_MV_MAX, or the cell's triple spilled past the
// table. Each cell is computed by exactly one thread:
// - a cell whose bucket is below nuniq takes its entry:
//     luma:   (hp[e3][Y + e4][X + e5] + hp[e6][Y + e7][X + e8] + 1) >> 1,
//             Y = pad - 2 + e1 + y, X = pad - 2 + e2 + x, of slot e0's K1
//             planes (uint8 [4, Ho, pitch]);
//     chroma: ((8-fx)(8-fy) A + fx (8-fy) B + (8-fx) fy C + fx fy D + 32)
//             >> 6 over the 2x2 samples at (cpad + e9 + y, cpad + e10 + x)
//             of slot e0's U or V plane, cpad = pad / 2;
// - else a cell listed in mc_fix takes the general prediction of
//   mc_luma_cells and mc_chroma_cells (ops/mc.py:40 and :97; the code K11
//   shares, csrc/mc_cell.cuh) from the raw
//   uint8 rings: its ref_slot clamped to the ring (any slot, active or
//   not), its MV clipped as iFullMV is clipped (chroma's bounds in luma
//   units through lpad = 2 cpad), the 6-tap b, h and j of a 9x9 window (j
//   from the unrounded b sums, (j + 512) >> 10), the quarter-pel
//   selection, and the 2x2 eighth-pel bilinear of U and V;
// - else the cell is 0.
// mc_fast_plan never lists a cell of the table (a listed cell's bucket is
// MC_CAP), so this is mc_bucketed_plain, which writes the fix-ups over the
// table's planes. The wrapper checks on the host that every entry's
// windows lie inside the planes, as the plain version does, so the table
// path does not clamp; the clip keeps every fix-up window inside the
// padded rings.
//
// What bounds it on the H100: bytes, and they are few. At 720p the
// function depends on the bucket plane (57,600 bytes), the fix list and
// the table (2 KB each), 1-2 samples of K1's planes per pixel (the
// samples its taps read, a sample that two taps or neighbouring cells
// share counted once), ~1 chroma sample per chroma pixel and plane, and
// the fix-up cells' windows, and writes three int32 planes (5.5 MB):
// 7.3-7.9 MB, ~0.0023 ms at 3.35 TB/s (chip_smoke.k6_bytes_ops counts
// them). What the design does:
// - one launch per frame and no loop over the triples: a thread owns one
//   4x4 cell and writes it once; neighbouring threads own neighbouring
//   cells of a cell row, so the loads of a tap row and the stores of a
//   pixel row are coalesced.
//   The 2 KB table goes to the kernel as a by-value parameter and to
//   shared memory, so a frame costs no host-to-device copy; the fix list,
//   ref_slot and mv are read in place from the plane dict's device
//   tensors. A CTA copies the 512-entry list to shared memory (4
//   coalesced loads a thread, issued beside the cell's bucket load, before
//   the one barrier); a table cell goes on at once, and only a cell
//   outside the table looks itself up in the copy (9 steps of a binary
//   search).
// - a cell's 4 luma rows are one 16-byte store each, its chroma rows one
//   8-byte store each.
// - the fix-up cells (at most 512 of 57,600) hold their 9x9 window in 27
//   registers, 4 bytes to a word, and compute only the half-pel samples
//   their quarter-pel case reads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mc_cell.cuh"

namespace {

constexpr int CAP = 32;      // table rows (MC_CAP)
constexpr int ENTRY = 16;    // int32 per row
constexpr int FIX_CAP = 512; // fix list entries (MC_FIX_CAP)
constexpr int THREADS = 128;
static_assert(FIX_CAP % THREADS == 0, "a thread loads FIX_CAP / THREADS");
static_assert((FIX_CAP & (FIX_CAP - 1)) == 0, "the search halves FIX_CAP");

struct Table {
  int32_t e[CAP][ENTRY];
};

// One active slot: K1's four uint8 planes [4, Ho, hp_pitch] (plane k at
// hp + k * hp_plane), and its U and V planes (row stride c_pitch).
struct Slot {
  const uint8_t* hp;
  const uint8_t* u;
  const uint8_t* v;
  long long hp_plane;
  int hp_pitch;
  int c_pitch;
};

using mcc::Rings;

// The plan's device tensors as the decoder uploads them: the fix list
// int32 [512], ref_slot int32 [n, 16] and mv int16 [n, 16, 2].
struct Cells {
  const int32_t* fix;
  const int32_t* ref_slot;
  const int16_t* mv;
};

using mcc::avg;
using mcc::byte_of;
using mcc::load_bytes;

// mc_luma_cells of one cell (mcc::cell_luma), stored: the 4x4 prediction
// at luma (cy, cx) from ring plane `ref` for the quarter-pel MV (vx, vy).
__device__ void fix_luma(const Rings& rg, const uint8_t* ref, int pad, int cy,
                         int cx, int vx, int vy, int4* oy, int W) {
  int out[4][4];
  mcc::cell_luma(rg, ref, pad, cy, cx, vx, vy, out);
#pragma unroll
  for (int y = 0; y < 4; ++y)
    oy[y * (W / 4)] = make_int4(out[y][0], out[y][1], out[y][2], out[y][3]);
}

// mc_chroma_cells of one cell for U and V (mcc::cell_chroma), stored: the
// 2x2 predictions at chroma (cy, cx) = luma (2 cy, 2 cx).
__device__ void fix_chroma(const Rings& rg, int slot, int cpad, int cy,
                           int cx, int vx, int vy, int2* ou, int2* ov,
                           int Wc_out) {
  int cu[2][2], cv[2][2];
  mcc::cell_chroma(rg, slot, cpad, cy, cx, vx, vy, cu, cv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ou[r * (Wc_out / 2)] = make_int2(cu[r][0], cu[r][1]);
    ov[r * (Wc_out / 2)] = make_int2(cv[r][0], cv[r][1]);
  }
}

// A table cell: entry e of its bucket (see the header) at cell row cr,
// column cc.
__device__ __forceinline__ void table_cell(const int32_t* e, const Slot& s0,
                                           const Slot& s1, int pad, int cr,
                                           int cc, int W, int Wc, int4* oy,
                                           int2* ou, int2* ov) {
  const Slot& s = e[0] ? s1 : s0;

  // luma: the rounded average of two half-pel plane taps
  const int ly = pad - 2 + e[1] + 4 * cr, lx = pad - 2 + e[2] + 4 * cc;
  const uint8_t* t1 = s.hp + e[3] * s.hp_plane +
                      (size_t)(ly + e[4]) * s.hp_pitch + (lx + e[5]);
  const uint8_t* t2 = s.hp + e[6] * s.hp_plane +
                      (size_t)(ly + e[7]) * s.hp_pitch + (lx + e[8]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t a = load_bytes<4>(t1 + (size_t)r * s.hp_pitch);
    const uint32_t b = load_bytes<4>(t2 + (size_t)r * s.hp_pitch);
    oy[r * (W / 4)] = make_int4(avg(byte_of(a, 0), byte_of(b, 0)),
                                avg(byte_of(a, 1), byte_of(b, 1)),
                                avg(byte_of(a, 2), byte_of(b, 2)),
                                avg(byte_of(a, 3), byte_of(b, 3)));
  }

  // chroma: the eighth-pel bilinear of the 2x2 cell, U and V
  const int fy = e[11], fx = e[12];
  const int w00 = (8 - fx) * (8 - fy), w01 = fx * (8 - fy);
  const int w10 = (8 - fx) * fy, w11 = fx * fy;
  const size_t at = (size_t)(pad / 2 + e[9] + 2 * cr) * s.c_pitch +
                    (pad / 2 + e[10] + 2 * cc);
#pragma unroll
  for (int plane = 0; plane < 2; ++plane) {
    const uint8_t* p = (plane ? s.v : s.u) + at;
    int2* o = plane ? ov : ou;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t a = load_bytes<3>(p + (size_t)r * s.c_pitch);
      const uint32_t b = load_bytes<3>(p + (size_t)(r + 1) * s.c_pitch);
      const int a0 = byte_of(a, 0), a1 = byte_of(a, 1), a2 = byte_of(a, 2);
      const int b0 = byte_of(b, 0), b1 = byte_of(b, 1), b2 = byte_of(b, 2);
      o[r * (Wc / 2)] =
          make_int2((w00 * a0 + w01 * a1 + w10 * b0 + w11 * b1 + 32) >> 6,
                    (w00 * a1 + w01 * a2 + w10 * b1 + w11 * b2 + 32) >> 6);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
mc_bucket_kernel(const Table tab, int nuniq,
                 const uint8_t* __restrict__ bucket, const Cells cells,
                 const Slot s0, const Slot s1, const Rings rg, int mb_w,
                 int mb_h, int pad,
                 int32_t* __restrict__ pred_y, int32_t* __restrict__ pred_u,
                 int32_t* __restrict__ pred_v) {
  __shared__ int32_t t[CAP * ENTRY];
  __shared__ uint32_t list[FIX_CAP];
  // the cell's bucket and this thread's share of the fix list load
  // together, before the one barrier; -1 (the list's padding) becomes the
  // largest unsigned value, so the list stays ascending
  const int cw = 4 * mb_w;                      // cells in a cell row
  const int at = blockIdx.x * THREADS + threadIdx.x;
  const bool live = at < cw * 4 * mb_h;
  const int cr = at / cw, cc = at % cw;         // cell row and column
  const int cell = ((cr >> 2) * mb_w + (cc >> 2)) * 16 + (cr & 3) * 4 +
                   (cc & 3);                    // the plan's index
  const int u = live ? bucket[cell] : CAP;
#pragma unroll
  for (int i = 0; i < FIX_CAP / THREADS; ++i)
    list[threadIdx.x + i * THREADS] =
        (uint32_t)cells.fix[threadIdx.x + i * THREADS];
  for (int i = threadIdx.x; i < CAP * ENTRY; i += THREADS)
    t[i] = tab.e[i / ENTRY][i % ENTRY];
  __syncthreads();
  if (!live) return;
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  int4* oy = reinterpret_cast<int4*>(pred_y + (size_t)(4 * cr) * W + 4 * cc);
  int2* ou = reinterpret_cast<int2*>(pred_u + (size_t)(2 * cr) * Wc + 2 * cc);
  int2* ov = reinterpret_cast<int2*>(pred_v + (size_t)(2 * cr) * Wc + 2 * cc);

  if (u < nuniq) {
    table_cell(t + u * ENTRY, s0, s1, pad, cr, cc, W, Wc, oy, ou, ov);
    return;
  }
  // a cell outside the table: a fix-up cell if the list holds it (a
  // binary search of the shared copy), else 0
  unsigned pos = 0;
#pragma unroll
  for (int step = FIX_CAP / 2; step > 0; step >>= 1)
    if (list[pos + step - 1] < (unsigned)cell) pos += step;
  if (list[pos] == (unsigned)cell) {
    const int slot = min(max(cells.ref_slot[cell], 0), rg.R - 1);
    const int vx = cells.mv[2 * cell], vy = cells.mv[2 * cell + 1];
    fix_luma(rg, rg.y + (size_t)slot * rg.y_slot, pad, 4 * cr, 4 * cc, vx,
             vy, oy, W);
    fix_chroma(rg, slot, pad / 2, 2 * cr, 2 * cc, vx, vy, ou, ov, Wc);
    return;
  }
  const int4 z4 = make_int4(0, 0, 0, 0);
  const int2 z2 = make_int2(0, 0);
#pragma unroll
  for (int r = 0; r < 4; ++r) oy[r * (W / 4)] = z4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ou[r * (Wc / 2)] = z2;
    ov[r * (Wc / 2)] = z2;
  }
}

}  // namespace

// table: host int32 [32, 16] (mc_uniq), copied into the launch's
// parameters. bucket: device uint8 [mb_w * mb_h, 16]; fix: device int32
// [512] (mc_fix); ref_slot: device int32 [mb_w * mb_h, 16] and mv: int16
// [mb_w * mb_h, 16, 2], contiguous. hp0 / hp1: K1's uint8 planes of active slot 0 / 1, plane k at
// hp + k * hp_plane, row pitch hp_pitch; slot0 / slot1: their ring slots
// (slot 1 may repeat slot 0). ring_y: uint8 [R, Hp, Wp], ring_u / ring_v:
// uint8 [R, Hcp, Wcp], unit column stride, slot and row strides in bytes.
// pred_y:
// int32 [16 mb_h, 16 mb_w]; pred_u / pred_v: int32 [8 mb_h, 8 mb_w],
// contiguous, 16-byte aligned.
extern "C" int pip_mc_bucket(
    const void* table, int nuniq, const void* bucket, const void* fix,
    const void* ref_slot, const void* mv,
    const void* hp0, long long hp_plane0, int hp_pitch0, int slot0,
    const void* hp1, long long hp_plane1, int hp_pitch1, int slot1,
    const void* ring_y, long long y_slot, int y_pitch, int Hp, int Wp,
    const void* ring_u, const void* ring_v, long long c_slot, int c_pitch,
    int Hcp, int Wcp, int R, void* pred_y, void* pred_u, void* pred_v,
    int mb_w, int mb_h, int pad, void* stream) {
  if (mb_w < 1 || mb_h < 1 || nuniq < 0 || nuniq > CAP || R < 1 ||
      slot0 < 0 || slot0 >= R || slot1 < 0 || slot1 >= R)
    return (int)cudaErrorInvalidValue;
  Table tab;
  const int32_t* src = static_cast<const int32_t*>(table);
  for (int i = 0; i < CAP * ENTRY; ++i) tab.e[i / ENTRY][i % ENTRY] = src[i];
  const uint8_t* ry = static_cast<const uint8_t*>(ring_y);
  const uint8_t* ru = static_cast<const uint8_t*>(ring_u);
  const uint8_t* rv = static_cast<const uint8_t*>(ring_v);
  const Slot s0 = {(const uint8_t*)hp0, ru + slot0 * c_slot,
                   rv + slot0 * c_slot, hp_plane0, hp_pitch0, c_pitch};
  const Slot s1 = {(const uint8_t*)hp1, ru + slot1 * c_slot,
                   rv + slot1 * c_slot, hp_plane1, hp_pitch1, c_pitch};
  const Rings rg = {ry,      ru,      rv,  y_slot, c_slot, y_pitch, c_pitch,
                    Hp,      Wp,      Hcp, Wcp,    R};
  const Cells cells = {(const int32_t*)fix, (const int32_t*)ref_slot,
                       (const int16_t*)mv};
  const int n_cells = 16 * mb_w * mb_h;
  mc_bucket_kernel<<<(n_cells + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
      tab, nuniq, (const uint8_t*)bucket, cells, s0, s1, rg, mb_w, mb_h, pad,
      (int32_t*)pred_y, (int32_t*)pred_u, (int32_t*)pred_v);
  return (int)cudaGetLastError();
}
