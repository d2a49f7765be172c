// K5: the encoder's dense integer-pel motion search of one reference.
//
// Replaces dense_full_search (losslessh264_tpu/ops/me.py:132-214), a
// jax.lax.scan inside a jit over the 2R+1 rows of displacements (the scan
// at :199). Plain torch version: losslessh264_tpu_torch/ops/me.py
// dense_full_search_plain; wrapper ops/me.dense_full_search.
//
// For the source luma cur [H, W] (16 | H, W; 8-bit samples, given as
// uint8 or int32) and the reference ref_pad [H+2R, W+2R] (uint8, any row
// stride: the encoder passes a slice of its padded reference), every
// 16x16, 16x8, 8x16 and 8x8 block of the frame gets the displacement
// (dy, dx) in [-R, R]^2 of least SAD, the FIRST such in dy-major raster
// order, and that SAD. JAX keeps a running best with a strict `<` while
// it visits idx = (dy+R)*(2R+1) + (dx+R) in increasing order; the kernel
// splits the displacements over lanes and keeps instead the least key
// (sad << 11) | idx, which is the same choice: the least SAD, then the
// least idx. A 16x16 SAD is at most 65280 < 2^16 and idx < 2^11 for
// R <= 22 (the wrapper refuses a larger radius), so a key fits 27 bits.
//
// What bounds it on the H100: integer instructions. At 720p (R = 16, 1089
// displacements) the search is 1.0e9 absolute differences and sums; the
// bytes are under 2 MB. An SM issues 62-64 lanes of any integer
// instruction a clock (tools/sad_rates.py), and the fastest way to a byte
// SAD is vabsdiff4 with its accumulate, 4 pixels an instruction: 1.0e9 / 4
// of them take ~0.016 ms on 132 SMs at the measured rate (tools/
// sad_rates.py prints the time). vabsdiff4, min, the logic
// ops and byte permutes share one pipe; IMAD and the dot products issue on
// another beside it (a vabsdiff4 + IMAD pair issues as fast as a
// vabsdiff4 alone). So the design spends as few other instructions of the
// first pipe as it can per SAD instruction:
// - a lane owns one 16x8 half of an MB (8 source rows, 32 words in
//   registers) at one horizontal displacement dx, and slides down the
//   2R+1 vertical ones: each reference row is loaded once (4 shared
//   loads) and serves the 8 source rows, i.e. 8 displacements dy at once,
//   into 8 running pairs of (left, right) 8x8 sums; a pair is complete,
//   and its keys taken, when its 8th row arrives. The reference window is
//   staged 4 times, shifted by 0-3 bytes, so a lane's words for any dx are
//   aligned words of one copy: no byte permutes. The copies' strides put
//   the 32 lanes of a load on 32 banks.
// - the blocks' sums and keys are IMADs and dot products: the lane's own
//   two 8x8 sums make its 16x8 sum; one shuffle with the MB's other half
//   (the adjacent lane) of the packed pair (left + right << 16), one add
//   and one dp2a give its 8x16 sum and the 16x16 sum; a key (sad << 11) +
//   idx is one IMAD by a multiplier the kernel takes as an argument (as a
//   constant the compiler would make it a shift and an add on the first
//   pipe). Per displacement a lane keeps 5 running keys (2 8x8, 16x8,
//   8x16, 16x16); two displacements' keys meet a running key in one
//   3-way min.
// - the first and last blocks of 8 steps of the slide hold displacements
//   outside [0, 2R]. When 2R+8 is a multiple of 8 (R = 16, the encoder's
//   radius) which rows they skip is known at compile time; else those
//   blocks test each row's displacement. The others run without tests.
//   (Testing each row in those two blocks too makes the search 17-21%
//   slower on an H100: tools/kernel_ab.py k5.)
// - a CTA takes a tile of 4 MBs of one MB row (64 x 16 px) and stages
//   the tile of cur and the 4 copies of its reference window ((16+2R)
//   rows of 64+2R bytes, and padding rows) in shared memory as uint8,
//   once, a word a thread at a time. A warp is 4 groups of 8 lanes (4
//   MBs x 2 halves), a group per dx; the 2R+1 values of dx go to
//   ceil((2R+1)/4) warps (9 at R = 16), one pass. The groups' keys meet
//   by shuffles, the warps' in shared memory; 40 threads (or the one
//   warp's 32) take the least of each and write the three int32 outputs.
//   720p has 900 such CTAs, ~7 per SM, so the last of them leaves SMs
//   idle for little of the time.
// A tile whose MBs run past the frame's right edge stages zeros there and
// drops those lanes' results; a lane whose dx is past 2R (the last warp's
// spare groups) repeats dx = 2R, so every lane takes part in every
// shuffle.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_MBS = 4;               // MBs of one MB row per CTA
constexpr int TILE_W = 16 * TILE_MBS;     // source columns per CTA
constexpr int CUR_W = TILE_W / 4;         // words of a staged source row
constexpr int GROUPS = 4;                 // dx groups of 8 lanes per warp
constexpr int MAX_WARPS = 12;
constexpr int NKEYS = 5;                  // keys a lane keeps
constexpr int IDX_BITS = 11;
constexpr int MAX_RADIUS = 22;            // (2R+1)^2 <= 2^IDX_BITS
constexpr unsigned FULL = 0xffffffffu;

struct Geometry {
  int span;      // 2R + 1
  int warps;     // ceil(span / GROUPS)
  int wrows;     // staged reference rows
  int pw;        // words of a staged reference row, 2 mod 4
  int cs;        // words of one shifted copy, 1 mod 32
  size_t smem;
};

Geometry geometry(int R) {
  Geometry g;
  g.span = 2 * R + 1;
  g.warps = (g.span + GROUPS - 1) / GROUPS;
  // steps t run in blocks of 8 while t < span + 7, and a lane reads row
  // t + 8 * half
  g.wrows = (g.span + 7 + 7) / 8 * 8 + 8;
  // a lane reads words k0 .. k0 + 3, k0 = 4 m + dx / 4. Rows 8 apart
  // (the two halves) fall 16 banks apart when pw is 2 mod 4; copies 1
  // bank apart when cs is 1 mod 32: the 32 lanes of a load (4 MBs x 2
  // halves x 4 copies) hit 32 banks.
  g.pw = 4 * (TILE_MBS - 1) + (g.span - 1) / 4 + 4;
  g.pw += (2 - g.pw % 4 + 4) % 4;
  g.cs = g.wrows * g.pw;
  g.cs += (1 - g.cs % 32 + 32) % 32;
  g.smem = sizeof(uint32_t) * ((size_t)16 * CUR_W + 4 * (size_t)g.cs +
                               (size_t)g.warps * 8 * NKEYS);
  return g;
}

// c + |a0-b0| + |a1-b1| + |a2-b2| + |a3-b3| over the bytes: one
// instruction
__device__ __forceinline__ uint32_t sad(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

// the blocks of 8 steps of the slide: every row's displacement valid, the
// first block (rows r <= s valid), the last when it ends the slide (rows
// r >= s valid), and any other (each row tested)
enum Mode { FAST, HEAD, TAIL, TESTED };

// One lane: the 8 source rows of its 16x8 half-MB, its dx, the 8 running
// (left, right) 8x8 sums of the slide, and its 5 running keys.
struct Lane {
  uint32_t c[8][4];
  uint32_t acc[8][2];
  uint32_t k[NKEYS];     // 8x8 left, 8x8 right, 16x8, 8x16, 16x16
  const uint32_t* rows;  // its words of reference row 0 in its copy
  int pw, span, dx;
  uint32_t vsel;         // the dp2a selector of its 8x16 half
  uint32_t kmul, half_mul, one;   // 1 << IDX_BITS, 1 << 16, 1

  // the keys of the five blocks at displacement row dy from its
  // completed 8x8 sums
  __device__ __forceinline__ void keys(uint32_t sl, uint32_t sr, int dy,
                                       uint32_t (&out)[NKEYS]) const {
    const uint32_t idx = (uint32_t)(dy * span + dx);
    out[0] = sl * kmul + idx;
    out[1] = sr * kmul + idx;
    out[2] = sl * kmul + out[1];
    const uint32_t pack = sr * half_mul + sl;
    const uint32_t both = __shfl_xor_sync(FULL, pack, 1) * one + pack;
    out[3] = __dp2a_lo(both, vsel, 0u) * kmul + idx;
    out[4] = __dp2a_lo(both, 0x0101u, 0u) * kmul + idx;
  }

  // steps t0 .. t0 + 7 of the slide: reference row t + 8 half adds its
  // SADs to displacement rows dy = t - r of source rows r = 0..7
  template <Mode M>
  __device__ __forceinline__ void block(int t0) {
    uint32_t held[NKEYS];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int t = t0 + s;
      if (M == TESTED && t >= span + 7) break;
      const uint32_t* w = rows + t * pw;
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = w[i];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const bool valid = M == FAST   ? true
                           : M == HEAD ? r <= s
                           : M == TAIL ? r >= s
                                       : (unsigned)(t - r) < (unsigned)span;
        if (valid) {
          uint32_t* q = acc[(s - r) & 7];
          const uint32_t l0 = r == 0 ? 0u : q[0], r0 = r == 0 ? 0u : q[1];
          q[0] = sad(c[r][1], a[1], sad(c[r][0], a[0], l0));
          q[1] = sad(c[r][3], a[3], sad(c[r][2], a[2], r0));
        }
      }
      const bool done = M == FAST || M == TAIL ? true
                        : M == HEAD            ? s == 7
                                    : t >= 7 && t - 7 < span;
      if (done) {
        const uint32_t* q = acc[(s + 1) & 7];
        uint32_t kk[NKEYS];
        keys(q[0], q[1], t - 7, kk);
        if (M == FAST || M == TAIL) {
          // the keys of steps 2i and 2i+1 meet the running ones at once
          if (s & 1) {
#pragma unroll
            for (int i = 0; i < NKEYS; ++i)
              k[i] = __vimin3_u32(k[i], held[i], kk[i]);
          } else {
#pragma unroll
            for (int i = 0; i < NKEYS; ++i) held[i] = kk[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < NKEYS; ++i) k[i] = min(k[i], kk[i]);
        }
      }
    }
  }
};

// cur: [H, W] samples of `cur_bytes` bytes each (1: uint8, 4: int32),
// row stride cur_stride elements. ref: [H+2R, W+2R] uint8, row stride
// ref_stride. out: int32 [3, 9n] = (dy, dx, sad) x (16x16 [n], 16x8
// [2n], 8x16 [2n], 8x8 [4n]), raster-MB-major. kmul: 1 << IDX_BITS.
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
me_dense_kernel(const void* __restrict__ cur, int cur_stride, int cur_bytes,
                const uint8_t* __restrict__ ref, int ref_stride, int mb_w,
                int mb_h, int R, int span, int wrows, int pw, int cs,
                uint32_t kmul, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* cur_s = reinterpret_cast<uint32_t*>(smem);   // [16][CUR_W]
  uint32_t* ref_s = cur_s + 16 * CUR_W;                   // [4][cs]
  uint32_t* keys_s = ref_s + 4 * cs;                      // [warps][8][5]
  const int W = 16 * mb_w, Hr = 16 * mb_h + 2 * R, Wr = W + 2 * R;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * 16;

  // stage the tile of cur, 4 samples to a word (zeros past the frame's
  // right edge)
  for (int e = threadIdx.x; e < 16 * CUR_W; e += blockDim.x) {
    const int r = e / CUR_W, x = x0 + 4 * (e % CUR_W);
    uint32_t v = 0;
    if (x < W) {
      const size_t at = (size_t)(y0 + r) * cur_stride + x;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t p =
            cur_bytes == 1
                ? static_cast<const uint8_t*>(cur)[at + b]
                : (uint8_t) static_cast<const int32_t*>(cur)[at + b];
        v |= p << (8 * b);
      }
    }
    cur_s[e] = v;
  }
  // stage the reference window: copy j holds each row moved left by j
  // bytes (zeros past the reference's right and bottom edges)
  const bool aligned = (reinterpret_cast<uintptr_t>(ref) & 3) == 0 &&
                       (ref_stride & 3) == 0;
  for (int e = threadIdx.x; e < wrows * pw; e += blockDim.x) {
    const int r = e / pw, x = x0 + 4 * (e % pw);
    uint32_t lo = 0, hi = 0;
    if (y0 + r < Hr) {
      const uint8_t* src = ref + (size_t)(y0 + r) * ref_stride + x;
      if (aligned && x + 8 <= Wr) {
        lo = reinterpret_cast<const uint32_t*>(src)[0];
        hi = reinterpret_cast<const uint32_t*>(src)[1];
      } else {
        for (int b = 0; b < 8 && x + b < Wr; ++b) {
          if (b < 4)
            lo |= (uint32_t)src[b] << (8 * b);
          else
            hi |= (uint32_t)src[b] << (8 * (b - 4));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ref_s[j * cs + e] = __funnelshift_r(lo, hi, 8 * j);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 3, m = (lane >> 1) & 3, half = lane & 1;
  Lane L;
  L.pw = pw;
  L.span = span;
  L.dx = min(warp * GROUPS + g, span - 1);
  L.vsel = half ? 0x0100u : 0x0001u;
  L.kmul = kmul;
  L.half_mul = kmul << (16 - IDX_BITS);
  L.one = kmul >> IDX_BITS;
  L.rows = ref_s + (L.dx & 3) * cs + 8 * half * pw + 4 * m + (L.dx >> 2);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      L.c[r][i] = cur_s[(8 * half + r) * CUR_W + 4 * m + i];
#pragma unroll
  for (int i = 0; i < NKEYS; ++i) L.k[i] = ~0u;

  for (int t0 = 0; t0 < span + 7; t0 += 8) {
    if (t0 == 0 && span >= 8)
      L.block<HEAD>(t0);
    else if (t0 >= 8 && t0 + 8 <= span)
      L.block<FAST>(t0);
    else if (t0 >= 8 && t0 == span - 1)
      L.block<TAIL>(t0);
    else
      L.block<TESTED>(t0);
  }

  // the least keys over the warp's 4 dx groups, then over the warps
#pragma unroll
  for (int i = 0; i < NKEYS; ++i) {
    L.k[i] = min(L.k[i], __shfl_xor_sync(FULL, L.k[i], 8));
    L.k[i] = min(L.k[i], __shfl_xor_sync(FULL, L.k[i], 16));
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < NKEYS; ++i)
      keys_s[(warp * 8 + lane) * NKEYS + i] = L.k[i];
  }
  __syncthreads();
  const int n = mb_w * mb_h;
  for (int o = threadIdx.x; o < 8 * NKEYS; o += blockDim.x) {
    const int l = o / NKEYS, which = o % NKEYS;
    uint32_t best = ~0u;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      best = min(best, keys_s[(w * 8 + l) * NKEYS + which]);
    const int mb_x = blockIdx.x * TILE_MBS + (l >> 1), h = l & 1;
    if (mb_x >= mb_w || (which == 4 && h)) continue;
    const int mb = blockIdx.y * mb_w + mb_x;
    // 8x8 (h, 0), 8x8 (h, 1), 16x8 (row h), 8x16 (column h), 16x16
    const int at = which == 0   ? 5 * n + 4 * mb + 2 * h
                   : which == 1 ? 5 * n + 4 * mb + 2 * h + 1
                   : which == 2 ? n + 2 * mb + h
                   : which == 3 ? 3 * n + 2 * mb + h
                                : mb;
    const int idx = (int)(best & ((1u << IDX_BITS) - 1));
    out[at] = idx / span - R;
    out[9 * n + at] = idx % span - R;
    out[18 * n + at] = (int)(best >> IDX_BITS);
  }
}

}  // namespace

// cur: [H, W] uint8 (cur_bytes 1) or int32 (cur_bytes 4), unit column
// stride, row stride cur_stride elements, values 0..255. ref: [H+2R,
// W+2R] uint8, unit column stride, row stride ref_stride. out: int32
// [3, 9 * mb_w * mb_h], contiguous. 0 <= R <= 22.
extern "C" int pip_me_dense(const void* cur, int cur_stride, int cur_bytes,
                            const void* ref, int ref_stride, void* out,
                            int mb_w, int mb_h, int R, void* stream) {
  if (R < 0 || R > MAX_RADIUS || mb_w < 1 || mb_h < 1 ||
      (cur_bytes != 1 && cur_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(R);
  const dim3 grid((mb_w + TILE_MBS - 1) / TILE_MBS, mb_h);
  me_dense_kernel<<<grid, g.warps * 32, g.smem, (cudaStream_t)stream>>>(
      cur, cur_stride, cur_bytes, (const uint8_t*)ref, ref_stride, mb_w,
      mb_h, R, g.span, g.wrows, g.pw, g.cs, 1u << IDX_BITS, (int32_t*)out);
  return (int)cudaGetLastError();
}
