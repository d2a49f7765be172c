// K6: the decoder's bucketed motion compensation of one P frame.
//
// Replaces the jax.lax.fori_loop of mc_bucketed (losslessh264_tpu/ops/
// mc.py:436-514, the loop at :512) over the frame's unique (slot, mv)
// triples. Plain torch version: losslessh264_tpu_torch/ops/mc.py
// mc_bucketed_plain; wrapper ops/mc.mc_bucketed, which also runs K1 for
// the half-pel planes before and the per-cell fix-ups after this kernel.
//
// The host plan (ops/mc.mc_fast_plan) gives every 4x4 luma cell a bucket
// u (uint8 [n, 16], raster-MB-major, raster cells in the MB) and every
// bucket an entry e = uniq[u] of 16 int32: e0 the slot (0 or 1), e1, e2
// the integer MV (mvy >> 2, mvx >> 2), e3..e8 the two half-pel taps
// (plane, dy, dx) of QTAB, e9, e10 the chroma integer MV (mv >> 3),
// e11, e12 the chroma fraction (mvy & 7, mvx & 7). Each pixel of a cell
// whose bucket is below nuniq is
//   luma:   (hp[e3][Y + e4][X + e5] + hp[e6][Y + e7][X + e8] + 1) >> 1,
//           Y = pad - 2 + e1 + y, X = pad - 2 + e2 + x, of slot e0's K1
//           planes (uint8 [4, Ho, pitch]);
//   chroma: ((8-fx)(8-fy) A + fx (8-fy) B + (8-fx) fy C + fx fy D + 32)
//           >> 6 over the 2x2 samples at (cpad + e9 + y, cpad + e10 + x)
//           of slot e0's U or V plane, cpad = pad / 2;
// and a cell whose bucket is nuniq or more (MC_CAP marks the cells the
// plan leaves to the fix-ups) is 0. The wrapper checks on the host that
// every entry's windows lie inside the planes, as the plain version does,
// so the kernel does not clamp.
//
// What bounds it on the H100: bytes, and they are few. At 720p the
// function reads the bucket plane (57,600 bytes), two luma taps per pixel
// and four chroma taps per chroma pixel and plane (3.7 MB), and writes
// three int32 planes (5.5 MB): ~0.003 ms at 3.35 TB/s. The loop it
// replaces issued ~15 torch ops and two full-plane selects per triple
// from the host. What the design does:
// - one launch per frame and no loop over the triples: a thread owns one
//   4x4 cell, reads its bucket once and its entry from a copy of the
//   table in shared memory, and writes the cell's 4 luma rows (one
//   16-byte store each) and its 2x2 U and V samples. The 2 KB table goes
//   to the kernel as a by-value parameter, so a frame costs no
//   host-to-device copy for it.
// - neighbouring threads own neighbouring cells of a cell row, so the
//   byte loads of a tap row and the stores of a pixel row are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAP = 32;      // table rows (MC_CAP)
constexpr int ENTRY = 16;    // int32 per row
constexpr int THREADS = 128;

struct Table {
  int32_t e[CAP][ENTRY];
};

// One reference slot: K1's four uint8 planes [4, Ho, hp_pitch] (plane k
// at hp + k * hp_plane), and its U and V planes (row stride c_pitch).
struct Slot {
  const uint8_t* hp;
  const uint8_t* u;
  const uint8_t* v;
  long long hp_plane;
  int hp_pitch;
  int c_pitch;
};

__global__ void __launch_bounds__(THREADS)
mc_bucket_kernel(const Table tab, int nuniq, const uint8_t* __restrict__ bucket,
                 const Slot s0, const Slot s1, int mb_w, int mb_h, int pad,
                 int32_t* __restrict__ pred_y, int32_t* __restrict__ pred_u,
                 int32_t* __restrict__ pred_v) {
  __shared__ int32_t t[CAP * ENTRY];
  for (int i = threadIdx.x; i < CAP * ENTRY; i += blockDim.x)
    t[i] = tab.e[i / ENTRY][i % ENTRY];
  __syncthreads();
  const int cw = 4 * mb_w;
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cw * 4 * mb_h) return;
  const int cr = cell / cw, cc = cell % cw;    // cell row and column
  const int W = 16 * mb_w, Wc = 8 * mb_w;
  const int u = bucket[((cr >> 2) * mb_w + (cc >> 2)) * 16 +
                       (cr & 3) * 4 + (cc & 3)];
  int4* oy = reinterpret_cast<int4*>(pred_y + (size_t)(4 * cr) * W + 4 * cc);
  int2* ou = reinterpret_cast<int2*>(pred_u + (size_t)(2 * cr) * Wc + 2 * cc);
  int2* ov = reinterpret_cast<int2*>(pred_v + (size_t)(2 * cr) * Wc + 2 * cc);
  if (u >= nuniq) {
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
  const int32_t* e = t + u * ENTRY;
  const Slot& s = e[0] ? s1 : s0;

  // luma: the rounded average of two half-pel plane taps
  const int ly = pad - 2 + e[1] + 4 * cr, lx = pad - 2 + e[2] + 4 * cc;
  const uint8_t* t1 = s.hp + e[3] * s.hp_plane +
                      (size_t)(ly + e[4]) * s.hp_pitch + (lx + e[5]);
  const uint8_t* t2 = s.hp + e[6] * s.hp_plane +
                      (size_t)(ly + e[7]) * s.hp_pitch + (lx + e[8]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint8_t* a = t1 + r * s.hp_pitch;
    const uint8_t* b = t2 + r * s.hp_pitch;
    oy[r * (W / 4)] = make_int4((a[0] + b[0] + 1) >> 1, (a[1] + b[1] + 1) >> 1,
                                (a[2] + b[2] + 1) >> 1, (a[3] + b[3] + 1) >> 1);
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
      const uint8_t* a = p + r * s.c_pitch;
      const uint8_t* b = a + s.c_pitch;
      const int v0 = (w00 * a[0] + w01 * a[1] + w10 * b[0] + w11 * b[1] + 32)
                     >> 6;
      const int v1 = (w00 * a[1] + w01 * a[2] + w10 * b[1] + w11 * b[2] + 32)
                     >> 6;
      o[r * (Wc / 2)] = make_int2(v0, v1);
    }
  }
}

}  // namespace

// table: host int32 [32, 16] (mc_uniq), copied into the launch's
// parameters. bucket: device uint8 [mb_w * mb_h, 16]. hp0 / hp1: K1's
// uint8 planes of slot 0 / 1, plane k at hp + k * hp_plane, row pitch
// hp_pitch; u0 / v0 / u1 / v1: the slots' chroma planes, row pitch
// c_pitch (slot 1 may repeat slot 0). pred_y: int32 [16 mb_h, 16 mb_w];
// pred_u / pred_v: int32 [8 mb_h, 8 mb_w], contiguous, 16-byte aligned.
extern "C" int pip_mc_bucket(const void* table, int nuniq, const void* bucket,
                             const void* hp0, long long hp_plane0,
                             int hp_pitch0, const void* u0, const void* v0,
                             int c_pitch0, const void* hp1,
                             long long hp_plane1, int hp_pitch1,
                             const void* u1, const void* v1, int c_pitch1,
                             void* pred_y, void* pred_u, void* pred_v,
                             int mb_w, int mb_h, int pad, void* stream) {
  if (mb_w < 1 || mb_h < 1 || nuniq < 0 || nuniq > CAP)
    return (int)cudaErrorInvalidValue;
  Table tab;
  const int32_t* src = static_cast<const int32_t*>(table);
  for (int i = 0; i < CAP * ENTRY; ++i) tab.e[i / ENTRY][i % ENTRY] = src[i];
  const Slot s0 = {(const uint8_t*)hp0, (const uint8_t*)u0,
                   (const uint8_t*)v0,  hp_plane0,
                   hp_pitch0,           c_pitch0};
  const Slot s1 = {(const uint8_t*)hp1, (const uint8_t*)u1,
                   (const uint8_t*)v1,  hp_plane1,
                   hp_pitch1,           c_pitch1};
  const int cells = 16 * mb_w * mb_h;
  mc_bucket_kernel<<<(cells + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(tab, nuniq,
                                             (const uint8_t*)bucket, s0, s1,
                                             mb_w, mb_h, pad, (int32_t*)pred_y,
                                             (int32_t*)pred_u,
                                             (int32_t*)pred_v);
  return (int)cudaGetLastError();
}
