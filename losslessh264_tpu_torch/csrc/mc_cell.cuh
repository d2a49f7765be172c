// The general motion compensation of one 4x4 luma cell and its 2x2
// chroma cells, as ops/mc.py's mc_luma_cells (:40) and mc_chroma_cells
// (:97) compute them, for the two kernels that predict cells one by one:
// K6 (csrc/mc_bucket.cu, its fix-up cells) and K11 (csrc/mc_cells.cu,
// every inter cell of a frame the bucketed plan does not serve).
//
// A cell reads the raw uint8 reference rings [R, Hp, Wp] (luma) and [R,
// Hcp, Wcp] (U, V): its MV clipped as the reference's BaseMC clips
// iFullMV into the padded planes (chroma's bounds in luma units through
// lpad = 2 cpad), the 6-tap b, h and j of a 9x9 luma window (j from the
// unrounded b sums, (j + 512) >> 10), the quarter-pel selection, and the
// 2x2 eighth-pel bilinear of U and V. The clip keeps every window inside
// the padded rings. The 9x9 window sits in 27 registers, 4 bytes to a
// word, and only the half-pel samples the cell's quarter-pel case reads
// are computed.
#pragma once
#include <stdint.h>

namespace mcc {

// The reference rings [R, Hp, Wp] (luma) and [R, Hcp, Wcp] (U, V), uint8,
// unit column stride; slot and row strides in bytes.
struct Rings {
  const uint8_t* y;
  const uint8_t* u;
  const uint8_t* v;
  long long y_slot, c_slot;
  int y_pitch, c_pitch;
  int Hp, Wp, Hcp, Wcp, R;
};

// The N (3 or 4) bytes at p in the low bytes of a little-endian word, by
// byte loads (on the H100 they beat one or two aligned word loads and a
// funnel shift here: tools/kernel_ab.py k6).
template <int N>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) v |= (uint32_t)p[i] << (8 * i);
  return v;
}

__device__ __forceinline__ int byte_of(uint32_t w, int k) {
  return (int)((w >> (8 * k)) & 0xffu);
}

__device__ __forceinline__ int sixtap(int a, int b, int c, int d, int e,
                                      int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

// The 9x9 luma window of a cell: row r, column c at byte c of w[r][c / 4].
struct Window {
  uint32_t w[9][3];
  __device__ __forceinline__ int at(int r, int c) const {
    return byte_of(w[r][c >> 2], c & 3);
  }
  // the unrounded 6-tap b of window row r at output column x
  __device__ __forceinline__ int bfull(int r, int x) const {
    return sixtap(at(r, x), at(r, x + 1), at(r, x + 2), at(r, x + 3),
                  at(r, x + 4), at(r, x + 5));
  }
  // the rounded 6-tap h of output row y at window column c
  __device__ __forceinline__ int hround(int y, int c) const {
    return clip255((sixtap(at(y, c), at(y + 1, c), at(y + 2, c),
                           at(y + 3, c), at(y + 4, c), at(y + 5, c)) +
                    16) >> 5);
  }
};

__device__ __forceinline__ int bround(int bf) {
  return clip255((bf + 16) >> 5);
}

// mc_luma_cells of one cell: out, the 4x4 prediction at luma (cy, cx)
// from ring plane `ref` (row stride rg.y_pitch) for the quarter-pel MV
// (vx, vy).
__device__ __forceinline__ void cell_luma(const Rings& rg, const uint8_t* ref,
                                          int pad, int cy, int cx, int vx,
                                          int vy, int out[4][4]) {
  const int H = rg.Hp - 2 * pad, Wr = rg.Wp - 2 * pad;
  const int lo = (2 - pad) * 4;
  const int fullx = min(max(cx * 4 + vx, lo), (Wr + pad - 19) * 4);
  const int fully = min(max(cy * 4 + vy, lo), (H + pad - 19) * 4);
  const int fx = fullx & 3, fy = fully & 3;
  const uint8_t* base = ref + (size_t)(pad + (fully >> 2) - 2) * rg.y_pitch +
                        (pad + (fullx >> 2) - 2);
  Window win;
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    const uint8_t* p = base + (size_t)r * rg.y_pitch;
    win.w[r][0] = load_bytes<4>(p);
    win.w[r][1] = load_bytes<4>(p + 4);
    win.w[r][2] = p[8];
  }
  if (fy == 0) {
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int G = win.at(y + 2, x + 2);
        const int b = bround(win.bfull(y + 2, x));
        out[y][x] = fx == 0   ? G
                    : fx == 1 ? avg(G, b)
                    : fx == 2 ? b
                              : avg(win.at(y + 2, x + 3), b);
      }
  } else if (fx == 0) {
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int G = win.at(y + 2, x + 2);
        const int hh = win.hround(y, x + 2);
        out[y][x] = fy == 1   ? avg(G, hh)
                    : fy == 2 ? hh
                              : avg(win.at(y + 3, x + 2), hh);
      }
  } else if (fx == 2 || fy == 2) {
    // j from the unrounded b of window rows y .. y + 5
    int bf[9][4];
#pragma unroll
    for (int r = 0; r < 9; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) bf[r][x] = win.bfull(r, x);
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = clip255((sixtap(bf[y][x], bf[y + 1][x], bf[y + 2][x],
                                      bf[y + 3][x], bf[y + 4][x],
                                      bf[y + 5][x]) +
                               512) >> 10);
        if (fx == 2) {
          out[y][x] = fy == 2   ? j
                      : fy == 1 ? avg(bround(bf[y + 2][x]), j)
                                : avg(bround(bf[y + 3][x]), j);
        } else {
          out[y][x] = avg(fx == 1 ? win.hround(y, x + 2)
                                  : win.hround(y, x + 3), j);
        }
      }
  } else {
    // the diagonals: the nearest b row and h column
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        out[y][x] = avg(bround(fy == 1 ? win.bfull(y + 2, x)
                                       : win.bfull(y + 3, x)),
                        fx == 1 ? win.hround(y, x + 2)
                                : win.hround(y, x + 3));
  }
}

// mc_chroma_cells of one cell for U and V: ou and ov, the 2x2 predictions
// at chroma (cy, cx) = luma (2 cy, 2 cx) of ring slot `slot` for the
// luma-unit MV (vx, vy).
__device__ __forceinline__ void cell_chroma(const Rings& rg, int slot,
                                            int cpad, int cy, int cx, int vx,
                                            int vy, int ou[2][2],
                                            int ov[2][2]) {
  const int Hc = rg.Hcp - 2 * cpad, Wc = rg.Wcp - 2 * cpad;
  const int lpad = 2 * cpad;
  const int lo = (2 - lpad) * 4;
  const int fullx = min(max(2 * cx * 4 + vx, lo), (2 * Wc + lpad - 19) * 4);
  const int fully = min(max(2 * cy * 4 + vy, lo), (2 * Hc + lpad - 19) * 4);
  const int fx = fullx & 7, fy = fully & 7;
  const size_t at = (size_t)slot * rg.c_slot +
                    (size_t)(cpad + (fully >> 3)) * rg.c_pitch +
                    (cpad + (fullx >> 3));
  const int w00 = (8 - fx) * (8 - fy), w01 = fx * (8 - fy);
  const int w10 = (8 - fx) * fy, w11 = fx * fy;
#pragma unroll
  for (int plane = 0; plane < 2; ++plane) {
    const uint8_t* p = (plane ? rg.v : rg.u) + at;
    int(*o)[2] = plane ? ov : ou;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint8_t* a = p + (size_t)r * rg.c_pitch;
      const uint8_t* b = a + rg.c_pitch;
      o[r][0] = (w00 * a[0] + w01 * a[1] + w10 * b[0] + w11 * b[1] + 32) >> 6;
      o[r][1] = (w00 * a[1] + w01 * a[2] + w10 * b[1] + w11 * b[2] + 32) >> 6;
    }
  }
}

}  // namespace mcc
