// K1: the four H.264 luma half-sample planes of one edge-padded reference.
//
// Replaces the Pallas kernel halfpel_planes_pallas / _hp_kernel
// (losslessh264_tpu/ops/mc.py:124-171). Plain torch version:
// losslessh264_tpu_torch/ops/mc.py halfpel_planes_plain.
//
// For an input plane r [Hp, Wp] (uint8) the output is [4, Hp-5, Wp-5]:
//   G(y,x) = r[y+2][x+2]
//   b(y,x) = clip((bf[y+2][x] + 16) >> 5)          bf = horizontal 6-tap
//   h(y,x) = clip((vertical 6-tap of r at column x+2, rows y..y+5 + 16) >> 5)
//   j(y,x) = clip((vertical 6-tap of bf at column x, rows y..y+5 + 512) >> 10)
// with the tap (1,-5,20,20,-5,1) and clip to 0..255. j filters the
// UNROUNDED horizontal sums bf, so they are kept in int32.
//
// What bounds it on the H100: memory. At 720p with PAD=32 it reads a
// 784x1344 uint8 plane (1.05 MB) and writes 4x779x1339 samples (4.2 MB
// as uint8, 16.7 MB as int32); the 6-tap arithmetic is ~40 int ops per
// output sample, far below the card's integer rate per byte moved.
// Design: one CTA per 32x64 output tile. The CTA stages the uint8 input
// tile plus its 5-row/5-column halo in shared memory (each input byte
// is read from device memory about once, instead of the 18 shifted
// reads of the slice formulation), computes bf for the tile's 37 rows
// once into shared memory, then every thread emits G, b, h and j for
// its samples; consecutive threads write consecutive columns, so the
// stores coalesce. Two entry points differ only in the output type:
// int32 (the JAX kernel's output contract) and uint8 (the internal
// entry the bucketed MC uses: every value is 0..255, a quarter of the
// bytes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;            // output rows per CTA
constexpr int TW = 64;            // output columns per CTA
constexpr int IH = TH + 5;        // input rows incl. halo
constexpr int IW = TW + 5;        // input columns incl. halo
constexpr int NTHREADS = 256;

__device__ __forceinline__ int sixtap(int a, int b, int c, int d, int e,
                                      int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
halfpel_kernel(const uint8_t* __restrict__ src, T* __restrict__ dst,
               int Hp, int Wp) {
  __shared__ int s_in[IH][IW];    // input tile + halo
  __shared__ int s_bf[IH][TW];    // unrounded horizontal sums
  const int Ho = Hp - 5, Wo = Wp - 5;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  // stage the input tile; samples past the plane only feed outputs past
  // the plane, which are never stored
  for (int i = tid; i < IH * IW; i += NTHREADS) {
    const int r = i / IW, c = i % IW;
    const int gy = y0 + r, gx = x0 + c;
    s_in[r][c] = (gy < Hp && gx < Wp) ? (int)src[(size_t)gy * Wp + gx] : 0;
  }
  __syncthreads();
  for (int i = tid; i < IH * TW; i += NTHREADS) {
    const int r = i / TW, c = i % TW;
    s_bf[r][c] = sixtap(s_in[r][c], s_in[r][c + 1], s_in[r][c + 2],
                        s_in[r][c + 3], s_in[r][c + 4], s_in[r][c + 5]);
  }
  __syncthreads();

  const size_t plane = (size_t)Ho * Wo;
  for (int i = tid; i < TH * TW; i += NTHREADS) {
    const int r = i / TW, c = i % TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= Ho || gx >= Wo) continue;
    const int g = s_in[r + 2][c + 2];
    const int b = clip255((s_bf[r + 2][c] + 16) >> 5);
    const int h = clip255((sixtap(s_in[r][c + 2], s_in[r + 1][c + 2],
                                  s_in[r + 2][c + 2], s_in[r + 3][c + 2],
                                  s_in[r + 4][c + 2], s_in[r + 5][c + 2])
                           + 16) >> 5);
    const int j = clip255((sixtap(s_bf[r][c], s_bf[r + 1][c], s_bf[r + 2][c],
                                  s_bf[r + 3][c], s_bf[r + 4][c],
                                  s_bf[r + 5][c]) + 512) >> 10);
    const size_t o = (size_t)gy * Wo + gx;
    dst[o] = (T)g;
    dst[plane + o] = (T)b;
    dst[2 * plane + o] = (T)h;
    dst[3 * plane + o] = (T)j;
  }
}

template <typename T>
int launch(const void* src, void* dst, int Hp, int Wp, void* stream) {
  const int Ho = Hp - 5, Wo = Wp - 5;
  dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH);
  halfpel_kernel<T><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (T*)dst, Hp, Wp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pip_halfpel_i32(const void* src, void* dst, int Hp, int Wp,
                               void* stream) {
  return launch<int32_t>(src, dst, Hp, Wp, stream);
}

extern "C" int pip_halfpel_u8(const void* src, void* dst, int Hp, int Wp,
                              void* stream) {
  return launch<uint8_t>(src, dst, Hp, Wp, stream);
}
