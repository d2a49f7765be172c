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
// splits the displacements over warps and keeps instead the least key
// (sad << 11) | idx, which is the same choice: the least SAD, then the
// least idx. A 16x16 SAD is at most 65280 < 2^16 and idx < 2^11 for
// R <= 22 (the wrapper refuses a larger radius), so a key fits 27 bits.
//
// What bounds it on the H100: operations. At 720p (R = 16, 1089
// displacements) the search is 1089 x 921,600 = 1.0e9 absolute
// differences and sums; the bytes are under 2 MB. What the design does:
// - bytes stay bytes, and a SAD is one video instruction for 4 pixels.
//   A CTA takes a tile of 8 MBs of one MB row (128 x 16 px). It stages
//   the tile of cur (16 x 128 bytes) and the reference window the tile's
//   displacements reach ((16+2R) rows of 128+2R bytes) in shared memory
//   as uint8, once. A lane owns one 8x8 quadrant of one MB: its 8 rows of
//   source stay in 16 registers, and per displacement a row costs two
//   __vsadu4 of the source words against reference words. The reference
//   words of a row at dx = 4k+j come from three aligned shared words by
//   __byte_perm, so one load of three words serves the 4 values of j.
// - the partitions are two shuffles. The four lanes of one MB are
//   adjacent (lane = 4 * MB + quadrant, quadrant = 2 * qy + qx), so at a
//   displacement the 16x8 sums are one __shfl_xor (qx), the 8x16 sums
//   another (qy) and the 16x16 sum a third; each lane keeps the running
//   least key of its 8x8, 16x8, 8x16 and 16x16 block in registers.
// - the rows of displacements spread over warps. A CTA has up to 12
//   warps, the 2R+1 rows of dy dealt to them evenly (11 warps of 3 rows
//   at R = 16); after the walk the warps' keys meet in shared memory and
//   warp 0 takes the least of each and writes the three int32 outputs.
// A tile whose MBs run past the frame's right edge stages zeros there and
// drops those lanes' results; every lane takes part in every shuffle.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_MBS = 8;               // MBs of one MB row per CTA
constexpr int TILE_W = 16 * TILE_MBS;     // source columns per CTA
constexpr int MAX_WARPS = 12;
constexpr int IDX_BITS = 11;
constexpr int MAX_RADIUS = 22;            // (2R+1)^2 <= 2^IDX_BITS
constexpr unsigned FULL = 0xffffffffu;

struct Geometry {
  int span;      // 2R + 1
  int chunks;    // groups of 4 horizontal displacements
  int pitch;     // bytes of one staged reference row
  int wrows;     // staged reference rows
  int warps;
  size_t smem;
};

Geometry geometry(int R) {
  Geometry g;
  g.span = 2 * R + 1;
  g.chunks = (g.span + 3) / 4;
  // a lane's last quadrant starts at byte 120 of the tile and reads
  // words k .. k+2 of a row for k < chunks
  const int need = TILE_W - 8 + 4 * (g.chunks + 2);
  g.pitch = (need + 15) / 16 * 16;
  g.wrows = 16 + 2 * R;
  const int rows_per_warp = (g.span + MAX_WARPS - 1) / MAX_WARPS;
  g.warps = (g.span + rows_per_warp - 1) / rows_per_warp;
  g.smem = (size_t)16 * TILE_W + (size_t)g.wrows * g.pitch +
           (size_t)g.warps * 32 * 4 * sizeof(uint32_t);
  return g;
}

__device__ __forceinline__ uint32_t key(uint32_t sad, uint32_t idx) {
  return (sad << IDX_BITS) | idx;
}

// cur: [H, W] samples of `cur_bytes` bytes each (1: uint8, 4: int32),
// row stride cur_stride elements. ref: [H+2R, W+2R] uint8, row stride
// ref_stride. out: int32 [3, 9n] = (dy, dx, sad) x (16x16 [n], 16x8
// [2n], 8x16 [2n], 8x8 [4n]), raster-MB-major.
__global__ void me_dense_kernel(const void* __restrict__ cur, int cur_stride,
                                int cur_bytes, const uint8_t* __restrict__ ref,
                                int ref_stride, int mb_w, int mb_h, int R,
                                int span, int chunks, int pitch, int wrows,
                                int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* cur_s = smem;                            // [16][TILE_W]
  uint8_t* ref_s = smem + 16 * TILE_W;              // [wrows][pitch]
  uint32_t* keys_s =
      reinterpret_cast<uint32_t*>(ref_s + (size_t)wrows * pitch);
  const int W = 16 * mb_w;
  const int x0 = blockIdx.x * TILE_W, y0 = blockIdx.y * 16;
  const int nwarps = blockDim.x >> 5;

  // stage the tile of cur and its reference window as bytes (zeros past
  // the frame's right edge)
  for (int e = threadIdx.x; e < 16 * TILE_W; e += blockDim.x) {
    const int r = e / TILE_W, x = x0 + e % TILE_W;
    uint8_t v = 0;
    if (x < W) {
      const size_t at = (size_t)(y0 + r) * cur_stride + x;
      v = cur_bytes == 1
              ? static_cast<const uint8_t*>(cur)[at]
              : (uint8_t) static_cast<const int32_t*>(cur)[at];
    }
    cur_s[e] = v;
  }
  for (int e = threadIdx.x; e < wrows * pitch; e += blockDim.x) {
    const int r = e / pitch, x = x0 + e % pitch;
    ref_s[e] = x < W + 2 * R ? ref[(size_t)(y0 + r) * ref_stride + x] : 0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mbl = lane >> 2, q = lane & 3, qy = q >> 1, qx = q & 1;
  const int bx = 16 * mbl + 8 * qx, by = 8 * qy;   // in the tile
  uint32_t c[8][2];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(cur_s + (by + r) * TILE_W + bx);
    c[r][0] = w[0];
    c[r][1] = w[1];
  }

  // running least keys: 8x8, 16x8 (this lane's half), 8x16, 16x16
  uint32_t k8 = ~0u, kh = ~0u, kv = ~0u, k16 = ~0u;
  for (int dy = warp; dy < span; dy += nwarps) {
    const uint8_t* rows = ref_s + (by + dy) * pitch + bx;
    for (int k = 0; k < chunks; ++k) {
      uint32_t acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(rows + r * pitch) + k;
        const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
        acc0 += __vsadu4(w0, c[r][0]) + __vsadu4(w1, c[r][1]);
        acc1 += __vsadu4(__byte_perm(w0, w1, 0x4321), c[r][0]) +
                __vsadu4(__byte_perm(w1, w2, 0x4321), c[r][1]);
        acc2 += __vsadu4(__byte_perm(w0, w1, 0x5432), c[r][0]) +
                __vsadu4(__byte_perm(w1, w2, 0x5432), c[r][1]);
        acc3 += __vsadu4(__byte_perm(w0, w1, 0x6543), c[r][0]) +
                __vsadu4(__byte_perm(w1, w2, 0x6543), c[r][1]);
      }
      const uint32_t accs[4] = {acc0, acc1, acc2, acc3};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dx = 4 * k + j;
        if (dx < span) {   // the same for every lane
          const uint32_t s8 = accs[j];
          const uint32_t sh = s8 + __shfl_xor_sync(FULL, s8, 1);
          const uint32_t sv = s8 + __shfl_xor_sync(FULL, s8, 2);
          const uint32_t s16 = sh + __shfl_xor_sync(FULL, sh, 2);
          const uint32_t idx = (uint32_t)(dy * span + dx);
          k8 = min(k8, key(s8, idx));
          kh = min(kh, key(sh, idx));
          kv = min(kv, key(sv, idx));
          k16 = min(k16, key(s16, idx));
        }
      }
    }
  }

  uint32_t* mine = keys_s + (warp * 32 + lane) * 4;
  mine[0] = k16;
  mine[1] = kh;
  mine[2] = kv;
  mine[3] = k8;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < nwarps; ++w) {
    const uint32_t* o = keys_s + (w * 32 + lane) * 4;
    k16 = min(k16, o[0]);
    kh = min(kh, o[1]);
    kv = min(kv, o[2]);
    k8 = min(k8, o[3]);
  }
  const int mb_x = blockIdx.x * TILE_MBS + mbl;
  if (mb_x >= mb_w) return;
  const int n = mb_w * mb_h;
  const int mb = blockIdx.y * mb_w + mb_x;
  auto put = [&](int at, uint32_t kk) {
    const int idx = (int)(kk & ((1u << IDX_BITS) - 1));
    out[at] = idx / span - R;
    out[9 * n + at] = idx % span - R;
    out[18 * n + at] = (int)(kk >> IDX_BITS);
  };
  if (q == 0) put(mb, k16);
  if (qx == 0) put(n + 2 * mb + qy, kh);
  if (qy == 0) put(3 * n + 2 * mb + qx, kv);
  put(5 * n + 4 * mb + q, k8);
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
      mb_h, R, g.span, g.chunks, g.pitch, g.wrows, (int32_t*)out);
  return (int)cudaGetLastError();
}
