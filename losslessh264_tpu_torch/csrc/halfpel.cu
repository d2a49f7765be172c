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
// UNROUNDED horizontal sums bf (|bf| < 2^14).
//
// What bounds it on the H100 (80 GB HBM3, 3.35 TB/s): the uint8 entry
// must read the plane and write 4 bytes per output position, at 720p
// (a 784x1344 plane) 5.23 MB or 1.56 us, at 1080p 3.39 us, at 2160p
// 12.9 us. Its arithmetic per position is three 6-taps and three
// round-and-clamps: at the SMs' issue rate of ~33.5 T lane-instructions
// a second, 50 instructions per position (chip_smoke.py's count) take as
// long as the bytes, so the design counts instructions as well as bytes.
// The int32 entry (the JAX contract) writes 4x the bytes and is bound by
// them. What the design does:
// - registers for the vertical taps. An item is a strip of 128 output
//   columns and `rows` output rows, and one warp walks it: each lane owns
//   4 consecutive columns and walks down the rows, keeping the last 6
//   input rows (for h) and the last 6 rows of bf (for j) in registers, so
//   no vertical tap reads shared memory. The row loop is unrolled by 6,
//   so the rolling windows are renamed registers, not moved ones; the 5
//   rows that only fill the windows are peeled off the loop.
// - two samples per instruction. b's and h's 6-taps run on two 16-bit
//   lanes of a word at once (sixtap2), on input bytes paired as columns
//   (c, c+2) by byte permutes; a bias of 2576 keeps every lane positive,
//   so no carry crosses lanes, and turns the rounding into a shift, a
//   mask and one DPX add-min-relu (__viaddmin_s16x2_relu) per two
//   samples. j needs 20 bits and runs on int32 lanes. Samples are packed
//   into bytes before they are stored.
// - bytes stay bytes. The warp stages its rows + 5 input rows (144 bytes
//   each, 133 used) in shared memory as uint8, 16 bytes at a time with
//   cp.async, in groups of 8 rows, and starts on the first group while
//   the others are in flight; a lane reads its 9 bytes of a row as 3
//   aligned words. A plane whose rows are not 16-byte aligned (Wp not a
//   multiple of 16, or a misaligned pointer) takes a byte-load path into
//   the same staging; only the loads differ.
// - wide stores. The uint8 entry writes into [4, Ho, pitch], pitch a
//   multiple of 16, so every lane stores one aligned word per plane and
//   row, a warp one 128-byte line; the caller reads the [..., :Wo] view.
//   The int32 entry keeps [4, Ho, Wo] contiguous, so its rows start at
//   any 4-byte boundary (every padded plane of the decoder has an odd
//   Wo = W + 59): a shuffle hands each lane the sample that makes every
//   store of the warp one 128-byte line.
// - the card filled in one wave. A CTA is 4 independent warps (no CTA
//   barrier). `rows` is 16 or 8, the larger that still gives every SM 16
//   warps, else 4: a 720p plane is 2145 items of 4 rows, 1080p 2304 of 8,
//   2160p 4309 of 16. Taller items cost fewer halo rows but leave warps
//   idle (32-row items at 2160p measured slower than 16).
// The launch and tail: one item (a 9x128 plane) takes ~2.2 us of device
// time, most of it the launch, one cold load and the store drain, so
// about half of the ~4.8 us of a 720p plane is that fixed cost
// (tools/kernel_ab.py k1 on NVIDIA H100 80GB HBM3, 700.00 W).
#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;     // warps per CTA, one item each
constexpr int COLS = 128;    // output columns per item: 4 per lane
constexpr int SROW = 144;    // staged bytes per input row (133 used)
constexpr int GROUP = 8;     // input rows per cp.async group

// The 6-tap (1,-5,20,20,-5,1) on int32 lanes.
__device__ __forceinline__ int sixtap(int a, int b, int c, int d, int e,
                                      int f) {
  return (a + f) + 20 * (c + d) - 5 * (b + e);
}

// The 6-tap on two 16-bit lanes of a word at once, plus BIAS in each
// lane. Each operand lane is a byte, so the positive part is at most
// 510 + 20 * 510 + BIAS and the negative part at most 5 * 510: every
// lane of the result lies in [BIAS - 2550, BIAS + 10710], inside 16 bits
// for BIAS = 2576, and no carry or borrow crosses between the lanes.
constexpr uint32_t BIAS = 2576;                   // 80 * 32 + 16
constexpr uint32_t BIAS2 = BIAS | (BIAS << 16);
__device__ __forceinline__ uint32_t sixtap2(uint32_t a, uint32_t b,
                                            uint32_t c, uint32_t d,
                                            uint32_t e, uint32_t f) {
  return (a + f + BIAS2) + 20u * (c + d) - 5u * (b + e);
}

// Two biased 6-tap sums v' = v + 2576 -> clip((v + 16) >> 5) per lane:
// (v + 16) >> 5 == (v' >> 5) - 80 exactly, and v' >> 5 < 512.
__device__ __forceinline__ uint32_t round5_2(uint32_t v) {
  return __viaddmin_s16x2_relu((v >> 5) & 0x01FF01FFu, 0xFFB0FFB0u,
                               0x00FF00FFu);
}

// Lanes (c0, c2) and (c1, c3) of 16 bits -> bytes c0 c1 c2 c3.
__device__ __forceinline__ uint32_t interleave(uint32_t even, uint32_t odd) {
  return __byte_perm(even, odd, 0x6240);
}

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` of this lane's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::); break;
  }
}

// Four samples of one plane row at column x, as the bytes of `v` (p
// points at column x).
__device__ __forceinline__ void store4(uint8_t* p, int x, int Wo,
                                       uint32_t v) {
  if (x < Wo)   // the pitch is a multiple of 16: the word is in the row
    *reinterpret_cast<uint32_t*>(p) = v;
}

// The int32 rows start at any 4-byte boundary. The warp stores each
// plane row as 4 lines of 32 consecutive samples: sample 32k + lane of
// the strip is byte lane % 4 of the word of lane 8k + lane / 4, fetched
// with a shuffle.
__device__ __forceinline__ void store4(int32_t* p, int x, int Wo,
                                       uint32_t v) {
  const int lane = threadIdx.x & 31;
  const int x0 = x - 4 * lane;
  int32_t* row = p - 4 * lane;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t w = __shfl_sync(0xffffffffu, v, 8 * k + (lane >> 2));
    if (x0 + 32 * k + lane < Wo)
      row[32 * k + lane] = __byte_perm(w, 0, 0x4440 | (lane & 3));
  }
}

// One lane's walk down an item, over rolling windows of the last 6
// input rows: per row, the input samples h reads (columns x+2..x+5, as
// two words of 16-bit lanes), the biased bf' = bf + 2576 of columns
// x..x+3 that j reads (int32), and the finished G and b words of the
// row (bytes), which output row y takes from input row y+2.
template <typename T>
struct Walk {
  uint32_t hin[6][2];
  int bf[6][4];
  uint32_t gw[6], bw[6];
  const uint8_t* stage;   // the next staged row; this lane's word 0
  T* out;                 // the next output row of G, this lane's column
  size_t plane;
  int pitch, x, Wo;

  // the next input row into slot K; with EMIT, the output row whose
  // window that row completes
  template <int K, bool EMIT>
  __device__ __forceinline__ void row() {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(stage);
    stage += SROW;
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
    // q[k] = (p[k], p[k+2]) in 16-bit lanes, p = this lane's 9 bytes
    const uint32_t m = __byte_perm(w0, w1, 0x5432);    // p2 p3 p4 p5
    const uint32_t n = __byte_perm(w1, w2, 0x5432);    // p6 p7 p8 -
    const uint32_t q0 = __byte_perm(w0, 0, 0x4240);
    const uint32_t q1 = __byte_perm(w0, 0, 0x4341);
    const uint32_t q2 = __byte_perm(m, 0, 0x4240);
    const uint32_t q3 = __byte_perm(m, 0, 0x4341);
    const uint32_t q4 = __byte_perm(w1, 0, 0x4240);
    const uint32_t q5 = __byte_perm(w1, 0, 0x4341);
    const uint32_t q6 = __byte_perm(n, 0, 0x4240);
    const uint32_t be = sixtap2(q0, q1, q2, q3, q4, q5);  // bf' x, x+2
    const uint32_t bo = sixtap2(q1, q2, q3, q4, q5, q6);  // bf' x+1, x+3
    bf[K][0] = be & 0xFFFF;
    bf[K][1] = bo & 0xFFFF;
    bf[K][2] = be >> 16;
    bf[K][3] = bo >> 16;
    bw[K] = interleave(round5_2(be), round5_2(bo));
    gw[K] = m;
    hin[K][0] = q2;   // columns x+2, x+4
    hin[K][1] = q3;   // columns x+3, x+5
    if (!EMIT) return;
    // slots of input rows y..y+5 of the output row y, oldest first
    constexpr int A = (K + 1) % 6, B = (K + 2) % 6, C = (K + 3) % 6,
                  D = (K + 4) % 6, E = (K + 5) % 6;
    const uint32_t h = interleave(
        round5_2(sixtap2(hin[A][0], hin[B][0], hin[C][0], hin[D][0],
                         hin[E][0], hin[K][0])),
        round5_2(sixtap2(hin[A][1], hin[B][1], hin[C][1], hin[D][1],
                         hin[E][1], hin[K][1])));
    // sum of the biased bf' is the sum of bf + 32 * 2576, and
    // (sum + 512) >> 10 == (sum' >> 10) - 80
    int j[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      j[c] = __viaddmin_s32_relu(
          sixtap(bf[A][c], bf[B][c], bf[C][c], bf[D][c], bf[E][c],
                 bf[K][c]) >> 10, -80, 255);
    const uint32_t jw = __byte_perm(__byte_perm(j[0], j[1], 0x0040),
                                    __byte_perm(j[2], j[3], 0x0040), 0x5410);
    store4(out, x, Wo, gw[C]);
    store4(out + plane, x, Wo, bw[C]);
    store4(out + 2 * plane, x, Wo, h);
    store4(out + 3 * plane, x, Wo, jw);
    out += pitch;
  }
};

// At most 102 registers a thread, so that 5 CTAs (20 warps) fit on an
// SM: left to itself, nvcc keeps whole 6-row blocks live in 167.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32, 5)
halfpel_strip_kernel(const uint8_t* __restrict__ src, T* __restrict__ dst,
                     int Hp, int Wp, int pitch, int rows, int strips,
                     int items, bool aligned) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int item = blockIdx.x * WARPS + warp;
  if (item >= items) return;
  const int Ho = Hp - 5;
  const int x0 = (item % strips) * COLS;
  const int y0 = (item / strips) * rows;
  const int n_in = min(rows, Ho - y0) + 5;
  uint8_t* stage = smem + (size_t)warp * (rows + 5) * SROW;
  const uint8_t* g = src + (size_t)y0 * Wp + x0;

  // stage input rows y0 .. y0+n_in-1, columns x0 .. x0+143 (zeros past
  // Wp: they feed only outputs past Wo, which are never stored)
  const int n_groups = (n_in + GROUP - 1) / GROUP;
  if (aligned) {
    constexpr int CH = SROW / 16;
    for (int gi = 0; gi < n_groups; ++gi) {
      const int end = min(n_in, (gi + 1) * GROUP) * CH;
      for (int e = gi * GROUP * CH + lane; e < end; e += 32) {
        const int r = e / CH, c = 16 * (e % CH);
        const bool ok = x0 + c < Wp;
        cp_async16(stage + r * SROW + c, ok ? g + (size_t)r * Wp + c : g,
                   ok);
      }
      cp_async_commit();
    }
  } else {
    for (int e = lane; e < n_in * SROW; e += 32) {
      const int r = e / SROW, c = e % SROW;
      stage[e] = x0 + c < Wp ? g[(size_t)r * Wp + c] : 0;
    }
    __syncwarp();
  }

  // input row r is in cp.async group r / GROUP
  auto wait_rows = [&](int last) {
    if (aligned) {
      cp_async_wait(n_groups - 1 - last / GROUP);
      __syncwarp();
    }
  };
  Walk<T> w;
  w.stage = stage + 4 * lane;
  w.x = x0 + 4 * lane;
  w.out = dst + (size_t)y0 * pitch + w.x;
  w.plane = (size_t)Ho * pitch;
  w.pitch = pitch;
  w.Wo = Wp - 5;
  // rows 0..4 only fill the windows; from row 5 on, row i (slot i % 6)
  // completes output row i - 5
  wait_rows(4);
  w.template row<0, false>();
  w.template row<1, false>();
  w.template row<2, false>();
  w.template row<3, false>();
  w.template row<4, false>();
  int i = 5;
  for (; i + 6 <= n_in; i += 6) {
    wait_rows(i + 5);
    w.template row<5, true>();
    w.template row<0, true>();
    w.template row<1, true>();
    w.template row<2, true>();
    w.template row<3, true>();
    w.template row<4, true>();
  }
  wait_rows(n_in - 1);
  if (i < n_in) w.template row<5, true>();
  if (i + 1 < n_in) w.template row<0, true>();
  if (i + 2 < n_in) w.template row<1, true>();
  if (i + 3 < n_in) w.template row<2, true>();
  if (i + 4 < n_in) w.template row<3, true>();
}

// The SM count of device `dev`, asked once per device and cached.
cudaError_t sm_count(int* out) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> cache[MAX_DEVICES];   // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) {
    *out = cache[dev].load(std::memory_order_relaxed);
    if (*out > 0) return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) cache[dev].store(*out, std::memory_order_relaxed);
  return cudaSuccess;
}

// Output rows per item: 16 or 8, the larger that still gives 16 warps
// to every SM, else 4.
int rows_per_item(int Ho, int strips, int sms) {
  for (int rows = 16; rows > 4; rows /= 2)
    if ((long)strips * ((Ho + rows - 1) / rows) >= 16L * sms) return rows;
  return 4;
}

template <typename T>
int launch(const void* src, void* dst, int Hp, int Wp, int pitch,
           void* stream) {
  const int Ho = Hp - 5, Wo = Wp - 5;
  if (Ho < 1 || Wo < 1 || pitch < Wo) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int strips = (Wo + COLS - 1) / COLS;
  const int rows = rows_per_item(Ho, strips, sms);
  const int items = strips * ((Ho + rows - 1) / rows);
  const bool aligned =
      Wp % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const size_t smem = (size_t)WARPS * (rows + 5) * SROW;
  halfpel_strip_kernel<T><<<(items + WARPS - 1) / WARPS, WARPS * 32, smem,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)src, (T*)dst, Hp, Wp, pitch, rows, strips, items,
      aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [Hp, Wp] uint8, contiguous. dst: [4, Hp-5, Wp-5] int32,
// contiguous (the JAX kernel's output contract).
extern "C" int pip_halfpel_i32(const void* src, void* dst, int Hp, int Wp,
                               void* stream) {
  return launch<int32_t>(src, dst, Hp, Wp, Wp - 5, stream);
}

// src: [Hp, Wp] uint8, contiguous. dst: [4, Hp-5, pitch] uint8 with
// pitch a multiple of 16 and at least Wp-5, 16-byte aligned; columns
// Wp-5 .. pitch-1 of each row are written with values of no meaning.
extern "C" int pip_halfpel_u8_pitched(const void* src, void* dst, int Hp,
                                      int Wp, int pitch, void* stream) {
  if (pitch % 16 != 0 || reinterpret_cast<uintptr_t>(dst) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return launch<uint8_t>(src, dst, Hp, Wp, pitch, stream);
}
