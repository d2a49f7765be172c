// K9: the loop filter's edge parameters of one frame (spec 8.7.2), written
// as K2's packed rows.
//
// Replaces the XLA program that computes _edge_params
// (losslessh264_tpu/ops/deblock.py:160, with compute_bs :35) and packs its
// planes into the rows the Pallas kernel reads (_pack_params,
// losslessh264_tpu/ops/deblock_pallas.py:181), inside the jitted
// deblock_pass (decoder_jax.py:698) and the encoder's _deblock_recon
// (encoder_jax.py:655). Plain torch version:
// losslessh264_tpu_torch/ops/deblock.py edge_params_packed_plain
// (_pack_params(_edge_params(...))); wrapper edge_params_packed, whose
// rows K2 (csrc/deblock.cu) reads next on the same stream.
//
// Output: one [384] int32 row per MB in _PACK_FIELDS order (bs_v, bs_h,
// tc0_v, tc0_h [4 edges x 16 lines]; alpha_v, beta_v, alpha_h, beta_h [4];
// bs_cv, bs_ch, tc0_cv, tc0_ch [2 x 8]; alpha_cv, beta_cv, alpha_ch,
// beta_ch [2]), lanes 344-383 zero. Every lane is a small gather and
// table lookup over the MB and its left or top neighbour; nothing is
// reduced.
//
// Inputs: ten symbol planes, each read in the dtype it arrives in (the
// decoder's uint8 / int8 / int16 / int64 planes, the encoder's int32 and
// bool ones) through a descriptor: pointer, kind, element strides, and a
// fill value for an absent plane (the encoder has no alpha_off, beta_off
// or transform8 plane, ref_idx may be absent, and its deblock_idc is one
// scalar). A value becomes int32 as torch's .to(torch.int32) makes it
// (zero or sign extension; an int64 is cut to its low 32 bits); nnz > 0
// and transform8 != 0 are tested on the value as it is, as the plain
// version does. The alpha, beta, tc0 and chroma-QP tables come as one
// device operand (ops/deblock._K9_TABLES, the pinned copies of ref_np).
//
// The plain version's neighbours are torch.roll()s of the frame's grids,
// so they wrap: MB column 0's left neighbour is the last MB of its row and
// MB row 0's top neighbour the last MB row. Those edges get bS 0 (pos 0),
// but their alpha, beta and tc0 lanes are still computed from the wrapped
// neighbour's QP, and this kernel reproduces them.
//
// What bounds it on the H100: bytes. At 720p (3600 MBs) with the
// decoder's planes it reads ~215 bytes per MB (128 of them the int64 nnz
// plane) and writes 1536: ~6.3 MB, ~0.0019 ms at 3.35 TB/s; the integer
// work (~1500 operations an MB, 5.4 M) takes ~0.0002 ms at the int32 rate.
// What the design does about it: one launch; a CTA of 256 threads takes
// two neighbouring MBs of one MB row (grid: MB pairs x MB rows, so no
// thread divides by the width). Three steps, a barrier between each:
// - stage: each MB's threads load what its lanes read into shared
//   memory, one value a thread, all at once: the 24 cells its edges touch
//   (its 16, the left neighbour's column 3, the top neighbour's row 3:
//   nnz > 0, ref_idx, the MV's two components), the three MBs' class, QP
//   and slice, its own idc, offsets and transform8 (109 threads); and the
//   CTA the 312-entry tables. So a thread waits on device memory once.
// - derive: 32 threads an MB compute its 32 distinct bS values (4 edges x
//   4 cells, each direction), 24 more its alpha and beta table indices
//   (4 luma and 2 chroma edges, each direction).
// - write: thread j writes lanes j, 128 + j and 256 + j of the MB's row,
//   each a lookup in shared memory, so each warp stores 128 contiguous
//   bytes three times.
// The waits set the time: a build that only stores the rows takes 1.6x
// the bound. Builds where a thread computed each lane's bS itself from
// the planes (waiting at each test of the bS chain), or staged but
// stored each value before it loaded the next (up to seven waits in a
// row), took 2-4.6x as long as this one (PERF.md, the K9 findings).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PW = 384;              // packed row width (lanes)
constexpr int MBS = 2;               // MBs per CTA, along a row
constexpr int TPM = PW / 3;          // threads per MB: 3 lanes each
constexpr int THREADS = MBS * TPM;

// plane kinds (ops/deblock._K9_KINDS)
enum Kind { ABSENT = 0, U8 = 1, I8 = 2, I16 = 3, I32 = 4, I64 = 5 };
// the planes, in the order of _edge_params' arguments
enum { CLS, QP, NNZ, MV, REF, SLICE, IDC, AOFF, BOFF, T8, NPLANES };
// one descriptor: pointer, kind, fill, strides in elements (6 int64 each)
constexpr int DESC = 6;
// table offsets: ALPHA [52], BETA [52], TC0 [52 x 3], CHROMA_QP [52]
constexpr int T_ALPHA = 0, T_BETA = 52, T_TC0 = 104, T_CQP = 260;
constexpr int T_LEN = 312;

struct Plane {
  const void* p;
  int kind;
  int fill;
  long long s0, s1, s2;
};

struct Args {
  Plane pl[NPLANES];
  const int32_t* tab;
  int32_t* out;
  int coff, mb_w, mb_h;
};

// the staged fields of a cell, and the staged scalars
enum { NZ, REFV, MVX, MVY, NFIELDS };
enum { S_CLS = 0, S_QP = 3, S_SLICE = 6, S_IDC = 9, S_AOFF, S_BOFF, S_T8,
       NSCALARS };

// one MB in shared memory. Staged: cell[f][r + 1][c + 1], field f of cell
// (r, c) for r, c in -1..3 (row -1: the top neighbour's row 3, column -1:
// the left neighbour's column 3); sc[S_CLS + k], sc[S_QP + k] and
// sc[S_SLICE + k] for MB k = 0 (the MB), 1 (left), 2 (top), and the MB's
// idc, offsets and transform8 != 0. Derived: bs[h][e][s], the bS of edge
// e at cell s in direction h (0: vertical edges, 1: horizontal); ia / ib,
// the alpha and beta indices of luma edge e (ia[h][e]) and chroma edge c
// (ia[h][4 + c]).
struct Stage {
  int cell[NFIELDS][5][5];
  int sc[NSCALARS];
  int bs[2][4][4];
  int ia[2][6], ib[2][6];
};

// the element at [i, j, k], as it is stored (absent: the fill value)
__device__ __forceinline__ long long raw(const Plane& a, long long i,
                                         long long j = 0, long long k = 0) {
  if (a.kind == ABSENT) return a.fill;
  const long long o = i * a.s0 + j * a.s1 + k * a.s2;
  switch (a.kind) {
    case U8: return static_cast<const uint8_t*>(a.p)[o];
    case I8: return static_cast<const int8_t*>(a.p)[o];
    case I16: return static_cast<const int16_t*>(a.p)[o];
    case I32: return static_cast<const int32_t*>(a.p)[o];
    default: return static_cast<const long long*>(a.p)[o];
  }
}

// the element as torch's .to(torch.int32) gives it
__device__ __forceinline__ int i32(const Plane& a, long long i,
                                   long long j = 0, long long k = 0) {
  return static_cast<int>(static_cast<uint32_t>(raw(a, i, j, k)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ bool intra(int cls) {
  return cls == 0 || cls == 1 || cls == 2 || cls == 8;
}

// |x - y| >= 4 as torch computes it in int32: the difference wraps, and
// the absolute value of INT32_MIN stays negative
__device__ __forceinline__ bool far4(int x, int y) {
  const int d = static_cast<int>(static_cast<uint32_t>(x)
                                 - static_cast<uint32_t>(y));
  return d >= 4 || (d <= -4 && d != INT32_MIN);
}

// the filter QP of staged MB k: 0 on a PCM MB
__device__ __forceinline__ int qps(const Stage& S, int k) {
  return S.sc[S_CLS + k] == 8 ? 0 : S.sc[S_QP + k];
}

// bS of edge e (0-3: cell column for h = 0, cell row for h = 1) at cell s
// along it, transform-8x8 mask applied: compute_bs, then _edge_params'
// kmask. pos0: the edge is on the picture's left (h = 0) or top border.
__device__ int edge_bs(const Stage& S, int h, int e, int s, bool pos0) {
  const int r = h ? e : s, c = h ? s : e;       // the q cell
  const int pr = h ? r - 1 : r, pc = h ? c : c - 1;
  const int pm = e ? 0 : 1 + h;                 // the p cell's MB
  const bool mb_edge = e == 0;
  const auto p = [&](int f) { return S.cell[f][pr + 1][pc + 1]; };
  const auto q = [&](int f) { return S.cell[f][r + 1][c + 1]; };
  int b;
  if (intra(S.sc[S_CLS]) || intra(S.sc[S_CLS + pm])) {
    b = mb_edge ? 4 : 3;
  } else if (p(NZ) || q(NZ)) {
    b = 2;
  } else {
    const bool far = far4(p(MVX), q(MVX)) || far4(p(MVY), q(MVY));
    b = (p(REFV) != q(REFV) || far) ? 1 : 0;
  }
  const int idc = S.sc[S_IDC];
  const bool cross = S.sc[S_SLICE + pm] != S.sc[S_SLICE];
  if (idc == 1 || (mb_edge && (pos0 || (idc == 2 && cross)))) b = 0;
  if ((e & 1) && S.sc[S_T8]) b = 0;
  return b;
}

// the QP edge x of direction h filters at: luma edges x = 0-3 (edge 0
// averages the neighbour's and the MB's QP, edges 1-3 are the MB's own),
// chroma edges x = 4 + c (each side through CHROMA_QP; edge 1 is the MB's
// own on both)
__device__ __forceinline__ int edge_qp(const Stage& S, const int* tab,
                                       int coff, int h, int x) {
  const int qq = qps(S, 0), qn = qps(S, 1 + h);
  if (x < 4) return x ? qq : (qn + qq + 1) >> 1;
  const int* cqp = tab + T_CQP;
  return (cqp[clampi((x == 4 ? qn : qq) + coff, 0, 51)]
          + cqp[clampi(qq + coff, 0, 51)] + 1) >> 1;
}

__device__ __forceinline__ int tc0(const int* tab, int ia, int b) {
  return tab[T_TC0 + ia * 3 + clampi(b, 1, 3) - 1];
}

__global__ void __launch_bounds__(THREADS) deblock_params(Args a) {
  __shared__ Stage stage[MBS];
  __shared__ int tab[T_LEN];
  const int m = threadIdx.x / TPM, j = threadIdx.x % TPM;
  const int mby = blockIdx.y, mbx = blockIdx.x * MBS + m;
  const bool live = mbx < a.mb_w;
  const int mb = mby * a.mb_w + mbx;
  // the left and top neighbours, wrapping as the plain version's
  // torch.roll does
  const int left = mby * a.mb_w + (mbx ? mbx - 1 : a.mb_w - 1);
  const int top = (mby ? mby - 1 : a.mb_h - 1) * a.mb_w + mbx;
  Stage& S = stage[m];
  for (int i = threadIdx.x; i < T_LEN; i += THREADS) tab[i] = a.tab[i];
  if (live && j < 24 * NFIELDS) {
    // field f of cell x: x 0-15 the MB's, 16-19 the left neighbour's
    // column 3, 20-23 the top neighbour's row 3
    const int x = j / NFIELDS, f = j % NFIELDS;
    const int r = x < 16 ? x >> 2 : x < 20 ? x - 16 : -1;
    const int c = x < 16 ? x & 3 : x < 20 ? -1 : x - 20;
    const int src = x < 16 ? mb : x < 20 ? left : top;
    const int cell = (r & 3) * 4 + (c & 3);
    S.cell[f][r + 1][c + 1] =
        f == NZ ? raw(a.pl[NNZ], src, cell) > 0
        : f == REFV ? i32(a.pl[REF], src, cell)
                    : i32(a.pl[MV], src, cell, f - MVX);
  } else if (live && j < 24 * NFIELDS + NSCALARS) {
    const int i = j - 24 * NFIELDS;
    const int k = i < S_IDC ? i % 3 : 0;
    const int src = k == 0 ? mb : k == 1 ? left : top;
    const int pl = i < S_QP ? CLS : i < S_SLICE ? QP : i < S_IDC ? SLICE
                                                     : IDC + i - S_IDC;
    S.sc[i] = pl == T8 ? raw(a.pl[T8], src) != 0 : i32(a.pl[pl], src);
  }
  __syncthreads();
  if (live) {
    if (j < 32) {
      const int h = j >> 4, e = (j >> 2) & 3;
      S.bs[h][e][j & 3] = edge_bs(S, h, e, j & 3,
                                  e == 0 && (h ? mby : mbx) == 0);
    } else if (j < 56) {
      const int h = (j - 32) / 12, x = (j - 32) % 12 >> 1;
      const int qp = edge_qp(S, tab, a.coff, h, x);
      if (j & 1)
        S.ib[h][x] = clampi(qp + S.sc[S_BOFF], 0, 51);
      else
        S.ia[h][x] = clampi(qp + S.sc[S_AOFF], 0, 51);
    }
  }
  __syncthreads();
  if (!live) return;
  int32_t* row = a.out + static_cast<long long>(mb) * PW;
  {
    // lane j: bs_v / bs_h [4 edges x 16 lines]; lane 128 + j: its tc0
    const int h = j >> 6, e = (j >> 4) & 3;
    const int b = S.bs[h][e][(j & 15) >> 2];
    row[j] = b;
    row[TPM + j] = tc0(tab, S.ia[h][e], b);
  }
  const int t = 2 * TPM + j;
  int v = 0;
  if (t < 272) {
    // alpha_v, beta_v, alpha_h, beta_h: [4 edges] each
    const int g = (t - 256) >> 2, e = t & 3, h = g >> 1;
    v = (g & 1) ? tab[T_BETA + S.ib[h][e]] : tab[T_ALPHA + S.ia[h][e]];
  } else if (t < 336) {
    // bs_cv, bs_ch, tc0_cv, tc0_ch: [2 edges x 8 lines] each, luma's
    // bS at edge 2c, line 2m
    const int field = (t - 272) >> 4, h = field & 1, c = (t >> 3) & 1;
    v = S.bs[h][2 * c][(t & 7) >> 1];
    if (field >= 2) v = tc0(tab, S.ia[h][4 + c], v);
  } else if (t < 344) {
    // alpha_cv, beta_cv, alpha_ch, beta_ch: [2 edges] each
    const int g = (t - 336) >> 1, c = t & 1, h = g >> 1;
    v = (g & 1) ? tab[T_BETA + S.ib[h][4 + c]]
                : tab[T_ALPHA + S.ia[h][4 + c]];
  }
  row[t] = v;
}

}  // namespace

// desc: host array of NPLANES descriptors (pointer, kind, fill, s0, s1,
// s2 as int64); tables: the device table operand; coff: the PPS chroma QP
// offset; out: [mb_w * mb_h, 384] int32.
extern "C" int pip_deblock_params(const long long* desc, const int32_t* tables,
                                  int coff, int32_t* out, int mb_w, int mb_h,
                                  cudaStream_t stream) {
  Args a;
  for (int i = 0; i < NPLANES; ++i) {
    const long long* d = desc + DESC * i;
    a.pl[i] = {reinterpret_cast<const void*>(d[0]), static_cast<int>(d[1]),
               static_cast<int>(d[2]), d[3], d[4], d[5]};
  }
  a.tab = tables;
  a.out = out;
  a.coff = coff;
  a.mb_w = mb_w;
  a.mb_h = mb_h;
  const dim3 grid((mb_w + MBS - 1) / MBS, mb_h);
  deblock_params<<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
