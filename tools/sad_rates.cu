// Throughput of the integer instructions a byte SAD can be built from,
// per SM per clock, on the card (tools/sad_rates.py builds and runs it).
//
// One CTA of 1024 threads per SM runs `iters` steps of 32 accumulators;
// a step applies the instruction once to each accumulator, and each takes
// two others as its operands (a rotation), so no step can be folded or
// hoisted by the compiler and the 32 warps of an SM keep every pipe fed.
// clock64() around the loop gives the SM's cycles. The loop is not
// unrolled, so its SASS is one step of each accumulator plus the loop's
// own few instructions; the tool prints that SASS by opcode, so the rate
// is of what ran.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 32;

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b, uint32_t c) {
  if (OP == 0) return __vsadu4(a, b);          // VABSDIFF4 with the sum
  if (OP == 1) return __vabsdiffu4(a, b);      // per-byte |a - b|
  if (OP == 2) return __byte_perm(a, b, 0x4321);
  if (OP == 3) return (uint32_t)__dp4a(a, b, (unsigned)c);
  if (OP == 4) return a ^ (b & c);             // one LOP3
  if (OP == 5) return a + b + c;               // one IADD3
  if (OP == 6) return min(a, b);               // VIMNMX
  if (OP == 7) return a * b + c;               // IMAD
  if (OP == 8) return __vsadu4(a, b) + c;     // SAD, then an add
  uint32_t d;                                  // OP 9: SAD with accumulate
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

template <int OP>
__global__ void __launch_bounds__(1024)
rate_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            int iters, long long* __restrict__ cycles) {
  uint32_t a[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) a[k] = in[(threadIdx.x + 7 * k) & 255];
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      a[k] = step<OP>(a[k], a[(k + 1) % CHAINS], a[(k + 2) % CHAINS]);
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) x ^= a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int OP>
int launch(const void* in, void* out, int iters, void* cycles, int blocks,
           cudaStream_t s) {
  rate_kernel<OP><<<blocks, 1024, 0, s>>>((const uint32_t*)in,
                                          (uint32_t*)out, iters,
                                          (long long*)cycles);
  return (int)cudaGetLastError();
}

}  // namespace

// in: 256 uint32 on the device; out: uint32 [blocks * 1024]; cycles:
// int64 [blocks]. op: 0..9 as in step().
extern "C" int rate_run(int op, const void* in, void* out, int iters,
                        void* cycles, int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0: return launch<0>(in, out, iters, cycles, blocks, s);
    case 1: return launch<1>(in, out, iters, cycles, blocks, s);
    case 2: return launch<2>(in, out, iters, cycles, blocks, s);
    case 3: return launch<3>(in, out, iters, cycles, blocks, s);
    case 4: return launch<4>(in, out, iters, cycles, blocks, s);
    case 5: return launch<5>(in, out, iters, cycles, blocks, s);
    case 6: return launch<6>(in, out, iters, cycles, blocks, s);
    case 7: return launch<7>(in, out, iters, cycles, blocks, s);
    case 8: return launch<8>(in, out, iters, cycles, blocks, s);
    case 9: return launch<9>(in, out, iters, cycles, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
