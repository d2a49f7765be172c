// The integer transforms and (de)quantization of H.264 as
// losslessh264_tpu_torch/ops/transform.py computes them, for the residual
// kernels: K7 (csrc/residual_dec.cu, the decode half) and K8
// (csrc/residual_enc.cu, the encode half). One call computes one
// coefficient or one 1-D transform of one block; the kernels hold a block
// in registers. Also the cp.async and barrier helpers of both kernels.
//
// JAX runs with 64-bit types off, so its int32 products, sums and left
// shifts wrap (ops/transform.py, the module docstring), and coefficients
// at the int16 extremes make them wrap in dequant. In C++ a signed
// overflow and a left shift of a negative value are undefined, and the
// compiler may rely on that; so every sum, product and left shift here is
// taken in uint32_t, whose arithmetic wraps as two's complement does, and
// only a right shift, a compare or a clamp reads the bits as int32 (sra
// below: the arithmetic shift, which is also a floored division by a power
// of two, as torch's and JAX's // of a negative int).
#pragma once
#include <stdint.h>

namespace tx {

typedef uint32_t u32;

// the bits of x as int32, shifted right arithmetically
__device__ __forceinline__ u32 sra(u32 x, int s) {
  return static_cast<u32>(static_cast<int32_t>(x) >> s);
}

__device__ __forceinline__ int32_t s32(u32 x) {
  return static_cast<int32_t>(x);
}

__device__ __forceinline__ int32_t clip255(u32 x) {
  const int32_t v = s32(x);
  return v < 0 ? 0 : v > 255 ? 255 : v;
}

// ref_np.V4 (dequant scales per qp % 6 and position class), ref_np.POS4
// (the class of each raster position of a 4x4 block), ref_np.V8 and POS8
// for 8x8 blocks, the quantizer's MF per qp % 6 and class (ops/transform.
// MF4_V) and ref_np.CHROMA_QP. tests/test_torch_residual_kernels.py reads
// these tables, and zz4's, back out of this file and compares them with
// the Python ones.
static __constant__ int32_t V4[6][3] = {
    {10, 16, 13}, {11, 18, 14}, {13, 20, 16},
    {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
static __constant__ int32_t POS4[16] = {0, 2, 0, 2, 2, 1, 2, 1,
                                        0, 2, 0, 2, 2, 1, 2, 1};
static __constant__ int32_t V8[6][6] = {
    {20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
    {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
    {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};
static __constant__ int32_t POS8[64] = {
    0, 3, 4, 3, 0, 3, 4, 3, 3, 1, 5, 1, 3, 1, 5, 1,
    4, 5, 2, 5, 4, 5, 2, 5, 3, 1, 5, 1, 3, 1, 5, 1,
    0, 3, 4, 3, 0, 3, 4, 3, 3, 1, 5, 1, 3, 1, 5, 1,
    4, 5, 2, 5, 4, 5, 2, 5, 3, 1, 5, 1, 3, 1, 5, 1};
static __constant__ int32_t MF4[6][3] = {
    {13107, 5243, 8066}, {11916, 4660, 7490}, {10082, 4194, 6554},
    {9362, 3647, 5825},  {8192, 3355, 5243},  {7282, 2893, 4559}};
static __constant__ int32_t CHROMA_QP[52] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
    18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
    34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

// cp.async: a copy of N = 4, 8 or 16 bytes from device memory into shared
// memory (both N-byte aligned) that lands by the cp_async_wait that
// follows its group's cp_async_commit; 16 bytes bypass L1 (.cg)
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
                 "l"(gmem), "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// POS4[i] as a constant expression: the class of raster position i of a
// 4x4 block, 0 where row and column are even, 1 where both are odd, 2
// elsewhere; so an unrolled loop picks a scale held in registers with it
__device__ __forceinline__ constexpr int pos4(int i) {
  return ((i >> 2) ^ i) & 1 ? 2 : i & 1;
}

// a barrier of the n threads (a multiple of 32) of the warps that call it
// with the same id (1..15; 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// the 4x4 zigzag (ref_np.ZZ4: the raster position of scan position i),
// one nibble per position: a constant expression, so that an unrolled
// loop indexes a block held in registers with it
__device__ __forceinline__ constexpr int zz4(int i) {
  return static_cast<int>((0xfeb7adc963258410ull >> (4 * i)) & 15);
}

// ---------------------------------------------------------------------
// decode half
// ---------------------------------------------------------------------

// one coefficient of dequant4 (qshift 4) or dequant8 (qshift 6)
// (ops/transform._dequant): c * (w * deq), then << (qp/6 - qshift), or
// the rounded >> (qshift - qp/6) of _round_shift; without a branch, as one
// of the two shifts is 0
__device__ __forceinline__ u32 dequant(u32 c, u32 w, u32 deq, int qdiv,
                                       int qshift) {
  const int shl = qdiv > qshift ? qdiv - qshift : 0;
  const int shr = qshift > qdiv ? qshift - qdiv : 0;
  const u32 rnd = shr ? 1u << (shr - 1) : 0u;
  return sra(((c * (w * deq)) << shl) + rnd, shr);
}

// luma_dc_dequant of one Hadamard-transformed I16 DC term: scale = w00 *
// V4[qp % 6][0], then << (qp/6 - 6) or the rounded >> (6 - qp/6)
__device__ __forceinline__ u32 luma_dc_dequant(u32 t, u32 w00, int qp) {
  return dequant(t, w00, static_cast<u32>(V4[qp % 6][0]), qp / 6, 6);
}

// chroma_dc_transform_dequant's dequant of one 2x2-transformed DC term:
// ((t * scale) << (qpc / 6)) >> 5
__device__ __forceinline__ u32 chroma_dc_dequant(u32 t, u32 w00, int qpc) {
  return sra((t * (w00 * static_cast<u32>(V4[qpc % 6][0]))) << (qpc / 6),
             5);
}

// output k (raster in the 2x2) of the 2x2 Hadamard of (a, b; c, d), as
// fhadamard2x2 and chroma_dc_transform_dequant compute it
__device__ __forceinline__ u32 had2_at(u32 a, u32 b, u32 c, u32 d, int k) {
  return k == 0 ? a + b + c + d : k == 1 ? a - b + c - d
       : k == 2 ? a + b - c - d : a - b - c + d;
}

// the inverse 4-point core transform in place (ops/transform._idct4_1d)
__device__ __forceinline__ void inv4(u32& a0, u32& a1, u32& a2, u32& a3) {
  const u32 e0 = a0 + a2, e1 = a0 - a2, e2 = sra(a1, 1) - a3,
            e3 = a1 + sra(a3, 1);
  a0 = e0 + e3;
  a1 = e1 + e2;
  a2 = e1 - e2;
  a3 = e0 - e3;
}

// idct4x4 of a raster 4x4 block: rows, then columns, then (v + 32) >> 6
__device__ __forceinline__ void idct4x4(u32 (&w)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) inv4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                   w[4 * i + 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) inv4(w[j], w[4 + j], w[8 + j], w[12 + j]);
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = sra(w[k] + 32u, 6);
}

// the 8-point core of idct8x8 (spec 8.5.12.2) over a[0], a[s], ... a[7s];
// idct8x8 is this over the rows, then the columns, then (v + 32) >> 6
__device__ __forceinline__ void inv8(u32* a, int s) {
  const u32 a0 = a[0], a1 = a[s], a2 = a[2 * s], a3 = a[3 * s];
  const u32 a4 = a[4 * s], a5 = a[5 * s], a6 = a[6 * s], a7 = a[7 * s];
  const u32 e0 = a0 + a4;
  const u32 e1 = 0u - a3 + a5 - a7 - sra(a7, 1);
  const u32 e2 = a0 - a4;
  const u32 e3 = a1 + a7 - a3 - sra(a3, 1);
  const u32 e4 = sra(a2, 1) - a6;
  const u32 e5 = 0u - a1 + a7 + a5 + sra(a5, 1);
  const u32 e6 = a2 + sra(a6, 1);
  const u32 e7 = a3 + a5 + a1 + sra(a1, 1);
  const u32 f0 = e0 + e6, f1 = e1 + sra(e7, 2), f2 = e2 + e4;
  const u32 f3 = e3 + sra(e5, 2), f4 = e2 - e4, f5 = sra(e3, 2) - e5;
  const u32 f6 = e0 - e6, f7 = e7 - sra(e1, 2);
  a[0] = f0 + f7;
  a[s] = f2 + f5;
  a[2 * s] = f4 + f3;
  a[3 * s] = f6 + f1;
  a[4 * s] = f6 - f1;
  a[5 * s] = f4 - f3;
  a[6 * s] = f2 - f5;
  a[7 * s] = f0 - f7;
}

// ---------------------------------------------------------------------
// encode half
// ---------------------------------------------------------------------

// the forward 4-point core transform in place (ops/transform._fwd4_last)
__device__ __forceinline__ void fwd4(u32& a0, u32& a1, u32& a2, u32& a3) {
  const u32 s0 = a0 + a3, s1 = a1 + a2, d0 = a0 - a3, d1 = a1 - a2;
  a0 = s0 + s1;
  a1 = 2u * d0 + d1;
  a2 = s0 - s1;
  a3 = d0 - 2u * d1;
}

// fdct4x4 of a raster 4x4 block: rows, then columns
__device__ __forceinline__ void fdct4x4(u32 (&w)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) fwd4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                   w[4 * i + 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) fwd4(w[j], w[4 + j], w[8 + j], w[12 + j]);
}

// |x| as torch.abs takes it on int32 (INT_MIN stays INT_MIN)
__device__ __forceinline__ u32 abs32(u32 x) {
  return s32(x) < 0 ? 0u - x : x;
}

// sign(w) * z
__device__ __forceinline__ u32 apply_sign(u32 w, u32 z) {
  return s32(w) < 0 ? 0u - z : s32(w) > 0 ? z : 0u;
}

// one level of quant4_pm for an inter block (rounding offset base // 6) at
// raster position pos, mf = MF4[qp % 6][pos4(pos)] and qbits = 15 + qp / 6:
// (|w| * MF + f) >> qbits, and with rd_lam >= 0 its trellis-lite rounding
// (ops/transform.quant4_pm: a level-1 coefficient goes to 0 when its
// remainder s256 = (u << 8) >> qbits falls below ((rd_lam * dr256 >> 8) -
// 256) // 2, the floored // an arithmetic >> 1)
//
// Without a branch: only a level of 1 can drop. For any other level dr256
// is 0, so the threshold is -128, while s256 >= -256 / 6 (u >= -f).
__device__ __forceinline__ u32 quant_inter(u32 w, int pos, u32 mf, int qbits,
                                           int rd_lam) {
  const u32 f = (1u << qbits) / 6u;
  const u32 t = abs32(w) * mf;
  const u32 z = sra(t + f, qbits);
  const u32 u = t - (z << qbits);
  const int32_t s256 = s32(sra(u << 8, qbits));
  const int32_t thr1 = s32(sra(
      sra(static_cast<u32>(rd_lam) * (768u + static_cast<u32>(pos) * 48u), 8)
          - 256u,
      1));
  const bool drop = rd_lam >= 0 && z == 1u && s256 < thr1;
  return apply_sign(w, drop ? 0u : z);
}

// quant_dc2 of one 2x2-transformed chroma DC term: (|y| * MF00 + 2 f)
// >> (qbits + 1), f = base // 3
__device__ __forceinline__ u32 quant_dc(u32 y, int qp) {
  const int qbits = 15 + qp / 6;
  const u32 f = (1u << qbits) / 3u;
  const u32 z = sra(abs32(y) * static_cast<u32>(MF4[qp % 6][0]) + 2u * f,
                    qbits + 1);
  return apply_sign(y, z);
}

}  // namespace tx
