// The port's own handle on the native symbol parse (native.SymbolDecoder):
// native/'s h264pip::SymbolDecoder (native/src/decsupport.h; the library
// native/libh264pip.so exports it) and one FramePlanes, which every frame
// of the handle is parsed into. The parse-ahead worker (sym_ahead.cpp)
// calls pip_pooled_next, pip_pooled_planes and pip_pooled_close, which
// take the arguments of native/'s pip_sym_next, pip_sym_planes and
// pip_sym_close. Built by g++ into build/host/libpip_plan.so
// (_build.host_lib), which links against native/libh264pip.so.
//
// native/'s own handle drops its planes every frame (a fresh
// FramePlanes()), so next_frame's `assign`s allocate ~8 MB a 720p frame
// anew, which glibc hands back to the kernel and the zero-fill faults in
// again. Here the planes keep their vectors: before each frame every
// other field reads what a fresh FramePlanes() reads, and the vectors'
// `assign`s reuse capacity that is faulted in already. A closed handle
// hands its planes to a process-wide pool, keyed by the MB count they
// hold, and a new handle takes planes of its stream's first SPS's MB
// count from there: a decoder is often opened for a few frames (a GOP, a
// pass over a clip), so the planes outlive it. A worker parses one frame
// at a time, so the pool holds at most one FramePlanes for each handle
// that was open at once, up to kPoolBytes in all (the bound of the
// worker's frame buffers in sym_ahead.cpp, kept apart from theirs).

#include <cstdint>
#include <cstring>
#include <exception>
#include <mutex>
#include <unordered_map>
#include <utility>
#include <vector>

#include "decsupport.h"

namespace {

using h264pip::FramePlanes;
using h264pip::u8;
using h264pip::i8;
using h264pip::i16;
using h264pip::i32;

// every vector of FramePlanes
#define PIP_PLANES(X)                                                     \
  X(mb_class) X(qp) X(cbp_luma) X(cbp_chroma) X(transform8) X(i16_mode)  \
  X(chroma_mode) X(i4_modes) X(luma_ac) X(luma_dc) X(luma8) X(chroma_ac) \
  X(chroma_dc) X(mv) X(ref_frame) X(ref_idx) X(part_tl) X(pcm)           \
  X(slice_id) X(deblock_idc) X(decoded) X(alpha_off) X(beta_off)         \
  X(wp_luma) X(wp_cb) X(wp_cr) X(wp_cmask)

size_t capacity_bytes(const FramePlanes& p) {
  size_t n = 0;
#define PIP_BYTES(v) n += p.v.capacity() * sizeof(p.v[0]);
  PIP_PLANES(PIP_BYTES)
#undef PIP_BYTES
  return n;
}

// Every field but the vectors back to what FramePlanes() reads; the
// vectors keep their contents and capacity (next_frame assigns each).
void reset(FramePlanes& p) {
  FramePlanes fresh = FramePlanes();
#define PIP_SWAP(v) fresh.v.swap(p.v);
  PIP_PLANES(PIP_SWAP)
#undef PIP_SWAP
  p = std::move(fresh);
}

struct Kept {
  FramePlanes* planes;
  int64_t mbs;  // the most MBs they have held
};

constexpr size_t kPoolBytes = size_t(256) << 20;
std::mutex g_pool_m;
std::unordered_map<int64_t, std::vector<Kept>> g_pool;  // by MB count
size_t g_pool_bytes = 0;

Kept take(int64_t mbs) {
  std::lock_guard<std::mutex> lk(g_pool_m);
  auto it = g_pool.find(mbs);
  if (it == g_pool.end() || it->second.empty()) return {nullptr, 0};
  Kept k = it->second.back();
  it->second.pop_back();
  g_pool_bytes -= capacity_bytes(*k.planes);
  return k;
}

void give_back(Kept k) {
  const size_t bytes = capacity_bytes(*k.planes);
  if (k.mbs > 0) {
    std::lock_guard<std::mutex> lk(g_pool_m);
    if (g_pool_bytes + bytes <= kPoolBytes) {
      g_pool[k.mbs].push_back(k);
      g_pool_bytes += bytes;
      return;
    }
  }
  delete k.planes;
}

// The MB count of the stream's first SPS, or 0 where there is none that
// parses: only which planes to take rests on it.
int64_t first_sps_mbs(const u8* d, size_t size) {
  for (size_t i = 0; i + 3 < size; ++i) {
    if (d[i] || d[i + 1] || d[i + 2] != 1 || (d[i + 3] & 0x1f) != 7)
      continue;
    const size_t s = i + 4;
    size_t e = s;
    while (e + 2 < size && (d[e] || d[e + 1] || d[e + 2] != 1)) ++e;
    if (e + 2 >= size) e = size;
    try {
      std::vector<u8> rbsp = h264pip::ebsp_to_rbsp(d + s, e - s);
      h264pip::BitReader br(rbsp.data(), rbsp.size());
      h264pip::Sps sps = h264pip::parse_sps(br);
      return int64_t(sps.mb_width()) * sps.mb_height();
    } catch (const std::exception&) {
      return 0;
    }
  }
  return 0;
}

struct Handle {
  h264pip::SymbolDecoder dec;
  Kept kept;
  Handle(const u8* d, size_t n, Kept k) : dec(d, n), kept(k) {}
};

void set_err(char* err, size_t cap, const char* msg) {
  if (err && cap) {
    std::strncpy(err, msg, cap - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Open a handle on the Annex-B stream `data` (copied), with planes from
// the pool where it holds some for the stream's size; null (err set) if
// the native layer refuses the stream.
void* pip_pooled_open(const u8* data, size_t size, char* err,
                      size_t err_cap) {
  Kept k = take(first_sps_mbs(data, size));
  try {
    if (!k.planes) k.planes = new FramePlanes();
    return new Handle(data, size, k);
  } catch (const std::exception& e) {
    if (k.planes) give_back(k);
    set_err(err, err_cap, e.what());
    return nullptr;
  }
}

// pip_sym_close: the planes go back to the pool.
void pip_pooled_close(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  give_back(h->kept);
  delete h;
}

// pip_sym_next: parse the next frame. Returns 2 (a frame, into planes
// that held at least as many MBs before), 1 (a frame, into planes that
// grew for it), 0 (the end) or -1 (an error; err set).
int pip_pooled_next(void* hv, int* mb_w, int* mb_h, char* err,
                    size_t err_cap) {
  Handle* h = static_cast<Handle*>(hv);
  FramePlanes& p = *h->kept.planes;
  try {
    reset(p);
    if (!h->dec.next_frame(&p)) return 0;
  } catch (const std::exception& e) {
    set_err(err, err_cap, e.what());
    return -1;
  }
  *mb_w = p.mb_w;
  *mb_h = p.mb_h;
  const int64_t n = int64_t(p.mb_w) * p.mb_h;
  if (n <= h->kept.mbs) return 2;
  h->kept.mbs = n;
  return 1;
}

// pip_sym_planes: copy the frame's planes out, as native/src/capi_sym.cc
// does.
int pip_pooled_planes(void* hv, u8* mb_class, u8* qp, u8* cbp_l, u8* cbp_c,
                      u8* t8, u8* i16m, u8* cmode, i8* i4m, i16* luma_ac,
                      i16* luma_dc, i16* luma8, i16* chroma_ac,
                      i16* chroma_dc, i16* mv, i16* ref_frame, u8* pcm,
                      u8* slice_id, u8* deblock_idc, i8* aoff, i8* boff,
                      i32* meta, u8* scaling, i16* wp_luma, i16* wp_cb,
                      i16* wp_cr, u8* wp_cmask, i8* ref_idx, u8* decoded,
                      u8* part_tl, i32* ref_list, i32* dpb_live) {
  const FramePlanes& f = *static_cast<Handle*>(hv)->kept.planes;
  const size_t n = size_t(f.mb_w) * f.mb_h;
  if (n == 0) return -1;
  std::memcpy(mb_class, f.mb_class.data(), n);
  std::memcpy(qp, f.qp.data(), n);
  std::memcpy(cbp_l, f.cbp_luma.data(), n);
  std::memcpy(cbp_c, f.cbp_chroma.data(), n);
  std::memcpy(t8, f.transform8.data(), n);
  std::memcpy(i16m, f.i16_mode.data(), n);
  std::memcpy(cmode, f.chroma_mode.data(), n);
  std::memcpy(i4m, f.i4_modes.data(), n * 16);
  std::memcpy(luma_ac, f.luma_ac.data(), n * 256 * 2);
  std::memcpy(luma_dc, f.luma_dc.data(), n * 16 * 2);
  std::memcpy(luma8, f.luma8.data(), n * 256 * 2);
  std::memcpy(chroma_ac, f.chroma_ac.data(), n * 128 * 2);
  std::memcpy(chroma_dc, f.chroma_dc.data(), n * 8 * 2);
  std::memcpy(mv, f.mv.data(), n * 32 * 2);
  std::memcpy(ref_frame, f.ref_frame.data(), n * 16 * 2);
  std::memcpy(pcm, f.pcm.data(), n * 384);
  std::memcpy(slice_id, f.slice_id.data(), n);
  std::memcpy(deblock_idc, f.deblock_idc.data(), n);
  std::memcpy(aoff, f.alpha_off.data(), n);
  std::memcpy(boff, f.beta_off.data(), n);
  meta[0] = f.use_scaling ? 1 : 0;
  meta[1] = f.chroma_qp_offset;
  meta[2] = f.second_chroma_qp_offset;
  meta[3] = f.is_ref ? 1 : 0;
  meta[4] = f.is_idr ? 1 : 0;
  meta[5] = f.intra_avail_mode;
  for (int i = 0; i < 4; ++i) meta[6 + i] = f.crop[i];
  meta[10] = f.lost_slices;
  std::memcpy(scaling, f.scaling4, 6 * 16);
  std::memcpy(scaling + 96, f.scaling8, 6 * 64);
  std::memcpy(wp_luma, f.wp_luma.data(), n * 48 * 2);
  std::memcpy(wp_cb, f.wp_cb.data(), n * 48 * 2);
  std::memcpy(wp_cr, f.wp_cr.data(), n * 48 * 2);
  std::memcpy(wp_cmask, f.wp_cmask.data(), n * 64);
  std::memcpy(ref_idx, f.ref_idx.data(), n * 16);
  std::memcpy(decoded, f.decoded.data(), n);
  std::memcpy(part_tl, f.part_tl.data(), n * 16);
  ref_list[0] = f.n_ref_list;
  std::memcpy(ref_list + 1, f.ref_list, sizeof(f.ref_list));
  dpb_live[0] = f.n_dpb_live;
  std::memcpy(dpb_live + 1, f.dpb_live, sizeof(f.dpb_live));
  return 0;
}

// What the pool holds: out[0] FramePlanes, out[1] their bytes.
int pip_pooled_kept(int64_t* out) {
  std::lock_guard<std::mutex> lk(g_pool_m);
  int64_t n = 0;
  for (const auto& kv : g_pool) n += int64_t(kv.second.size());
  out[0] = n;
  out[1] = int64_t(g_pool_bytes);
  return 0;
}

}  // extern "C"
