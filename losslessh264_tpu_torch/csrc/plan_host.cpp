// The decoder's per-frame host plan in compiled code: the nnz plane and
// the bucketed-MC plan that TorchDecoder._prep_planes uploads. Plain
// C++17 for the host (no CUDA), built by g++ into its own library,
// build/host/libpip_plan.so (_build.host_lib), and called through ctypes,
// which releases the interpreter lock for the call. Nothing here keeps
// state between calls, so threads may call at once.
//
// pip_plan_nnz is TorchDecoder._nnz_plane; pip_plan_mc is
// ops/mc.mc_fast_plan, step by step. Both read the symbol layer's arrays
// as it exports them (uint8 per-MB bytes, int16 levels and MVs) and the
// int32 ref_slot plane; the Python wrappers check dtypes, shapes and
// C-contiguity before they pass the pointers.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

// The nonzero int16 values among v[0..len), len a multiple of 4: four
// lanes to a 64-bit word, whose lanes' high bits say nonzero after the
// add, summed by one multiply.
inline int64_t count_nonzero(const int16_t* v, int len) {
  const uint64_t low15 = 0x7FFF7FFF7FFF7FFFull, ones = 0x0001000100010001ull;
  uint64_t lanes = 0;
  for (int i = 0; i < len; i += 4) {
    uint64_t w;
    std::memcpy(&w, v + i, 8);
    lanes += ((((w & low15) + low15) | w) >> 15) & ones;
  }
  return static_cast<int64_t>((lanes * ones) >> 48);
}

// One distinct (slot, mv) key of the fast cells: its cell count and, once
// the plan is cut, its row in the table (-1: spilled to the fix-ups).
struct Entry {
  int64_t key;
  int64_t count;
  int32_t rank;
};

// Open-addressing table from key to Entry, grown to stay at most half
// full; keys of fast cells are >= 0, so -1 marks an empty slot.
class KeyTable {
 public:
  KeyTable() { slots_.assign(size_t{1} << bits_, Entry{-1, 0, -1}); }

  Entry& find(int64_t key) {
    const size_t mask = slots_.size() - 1;
    size_t i = (static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull) >>
               (64 - bits_);
    while (slots_[i].key != key && slots_[i].key != -1) i = (i + 1) & mask;
    return slots_[i];
  }

  void add(int64_t key, int64_t count) {
    if (2 * (used_ + 1) > slots_.size()) grow();
    Entry& e = find(key);
    if (e.key == -1) {
      e.key = key;
      ++used_;
    }
    e.count += count;
  }

  const std::vector<Entry>& slots() const { return slots_; }

 private:
  void grow() {
    std::vector<Entry> old(slots_.size() * 2, Entry{-1, 0, -1});
    old.swap(slots_);
    ++bits_;
    for (const Entry& e : old)
      if (e.key != -1) find(e.key) = e;
  }

  int bits_ = 10;
  size_t used_ = 0;
  std::vector<Entry> slots_;
};

enum : uint8_t { kNone = 0, kFix = 1, kFast = 2 };

}  // namespace

extern "C" {

// The [n, 16] int64 nnz plane of TorchDecoder._nnz_plane: per 4x4 block
// (raster order in the MB) its nonzero levels when its 8x8 block's bit of
// cbp_luma is set, else 0; an MB with the 8x8 transform (but I16x16,
// class 1) gives each 4x4 block its 8x8 block's count; PCM (class 8) 16.
int pip_plan_nnz(const uint8_t* mb_class, const uint8_t* transform8,
                 const uint8_t* cbp_luma, const int16_t* luma_ac,
                 const int16_t* luma8, int n, int64_t* out) {
  if (n < 0) return 1;
  for (int mb = 0; mb < n; ++mb) {
    int64_t* o = out + int64_t{mb} * 16;
    const unsigned cbp = cbp_luma[mb];
    if (mb_class[mb] == 8) {
      std::fill(o, o + 16, int64_t{16});
    } else if (transform8[mb] != 0 && mb_class[mb] != 1) {
      for (int b8 = 0; b8 < 4; ++b8) {
        const int64_t c =
            (cbp >> b8) & 1
                ? count_nonzero(luma8 + (int64_t{mb} * 4 + b8) * 64, 64)
                : 0;
        const int by = b8 / 2, bx = b8 % 2;
        for (int sy = 0; sy < 2; ++sy)
          for (int sx = 0; sx < 2; ++sx)
            o[(by * 2 + sy) * 4 + bx * 2 + sx] = c;
      }
    } else {
      for (int b = 0; b < 16; ++b) {
        const int b8 = (b / 8) * 2 + (b % 4) / 2;
        o[b] = (cbp >> b8) & 1
                   ? count_nonzero(luma_ac + (int64_t{mb} * 16 + b) * 16, 16)
                   : 0;
      }
    }
  }
  return 0;
}

// ops/mc.mc_fast_plan. Inputs: ref_slot [n, 16] int32 (-1: no inter
// prediction), mv [n, 16, 2] int16 (x, y quarter-pels), the frame's
// geometry and padding, the caps (MC_CAP <= 255, MC_SLOT_CAP, MC_FIX_CAP,
// MC_MV_MAX) and QTAB [16, 6] int32. Writes every output in full: uniq
// [cap, 16] int32, slots [slot_cap] int32, bucket [n, 16] uint8 and fix
// [fix_cap] int32, and info [4] int32 = (mc_fast, mc_nuniq, mc_nslots,
// spilled: the fast cells' distinct triples exceeded cap). A frame the
// caps exclude gets mc_fast_plan's default plan (info[3] still says
// whether it spilled).
//
// Over cap triples the plan keeps the cap most populated ones. numpy's
// argsort(-cnt) breaks ties at the cut in no stated order; here a tie
// is broken by the key, ascending (the lower slot, then the lower mvy,
// then the lower mvx is kept). Under a tie the two plans may serve
// different triples densely: the counts of triples and fix-up cells
// stay equal, and both predict the same pixels.
int pip_plan_mc(const int32_t* ref_slot, const int16_t* mv, int mb_w,
                int mb_h, int pad, int cap, int slot_cap, int fix_cap,
                int mv_max, const int32_t* qtab, int32_t* uniq,
                int32_t* slots, uint8_t* bucket, int32_t* fix,
                int32_t* info) {
  if (mb_w < 0 || mb_h < 0 || cap < 0 || cap > 255 || slot_cap < 0 ||
      fix_cap < 0)
    return 1;
  const int64_t n = int64_t{mb_w} * mb_h;
  const int64_t cells = n * 16;
  const int64_t H = int64_t{mb_h} * 16, W = int64_t{mb_w} * 16;
  std::fill(uniq, uniq + int64_t{cap} * 16, 0);
  std::fill(slots, slots + slot_cap, 0);
  std::fill(bucket, bucket + cells, static_cast<uint8_t>(cap));
  std::fill(fix, fix + fix_cap, -1);
  std::fill(info, info + 4, 0);

  // each cell: no prediction, a fix-up (the iFullMV clip engages or the
  // MV is longer than mv_max) or fast, and its key
  const int64_t lo = int64_t{-pad + 2} * 4;
  const int64_t hi_x = (W + pad - 19) * 4, hi_y = (H + pad - 19) * 4;
  std::unique_ptr<uint8_t[]> kind(new uint8_t[cells]);
  std::unique_ptr<int64_t[]> key(new int64_t[cells]);
  KeyTable table;   // the distinct triples of the fast cells, and counts
  bool any_valid = false;
  int64_t nfix = 0;
  for (int64_t mb = 0; mb < n; ++mb) {
    const int64_t y0 = (mb / mb_w) * 16, x0 = (mb % mb_w) * 16;
    uint8_t* kd = kind.get() + mb * 16;
    int64_t* k = key.get() + mb * 16;
    const int32_t* rs = ref_slot + mb * 16;
    const int16_t* v = mv + mb * 32;
    for (int c = 0; c < 16; ++c) {
      const int64_t vx = v[2 * c], vy = v[2 * c + 1];
      const int64_t fx = (x0 + (c % 4) * 4) * 4 + vx;
      const int64_t fy = (y0 + (c / 4) * 4) * 4 + vy;
      const bool bad = (fx < lo) | (fx > hi_x) | (fy < lo) | (fy > hi_y) |
                       (vx > mv_max) | (-vx > mv_max) | (vy > mv_max) |
                       (-vy > mv_max);
      kd[c] = rs[c] < 0 ? kNone : bad ? kFix : kFast;
      // (rs << 28) + ((vy + 2^13) << 14) + (vx + 2^13), as products: the
      // terms of the cells that are not fast may be negative
      k[c] = int64_t{rs[c]} * (1 << 28) + (vy + (1 << 13)) * (1 << 14) +
             (vx + (1 << 13));
    }
    bool uniform = true;   // 16 fast cells of one key: added at once
    for (int c = 0; c < 16; ++c)
      uniform &= (kd[c] == kFast) & (k[c] == k[0]);
    if (uniform) {
      table.add(k[0], 16);
      any_valid = true;
      continue;
    }
    for (int c = 0; c < 16; ++c) {
      any_valid |= kd[c] != kNone;
      nfix += kd[c] == kFix;
      if (kd[c] == kFast) table.add(k[c], 1);
    }
  }
  if (!any_valid) return 0;   // nothing to predict: the default plan

  std::vector<Entry> found;
  for (const Entry& e : table.slots())
    if (e.key != -1) found.push_back(e);
  const bool spilled = static_cast<int64_t>(found.size()) > cap;
  info[3] = spilled;

  // over cap: the cap most populated triples are kept (ties: the lower
  // key), the others' cells spill to the fix-ups
  int64_t spilled_cells = 0;
  if (spilled) {
    std::nth_element(found.begin(), found.begin() + cap, found.end(),
                     [](const Entry& a, const Entry& b) {
                       return a.count != b.count ? a.count > b.count
                                                 : a.key < b.key;
                     });
    for (auto e = found.begin() + cap; e != found.end(); ++e)
      spilled_cells += e->count;
    found.resize(cap);
  }
  std::sort(found.begin(), found.end(),
            [](const Entry& a, const Entry& b) { return a.key < b.key; });
  std::vector<int64_t> slot_list;
  for (const Entry& e : found)
    if (slot_list.empty() || slot_list.back() != e.key >> 28)
      slot_list.push_back(e.key >> 28);
  const int64_t nuniq = static_cast<int64_t>(found.size());
  const int64_t nslots = static_cast<int64_t>(slot_list.size());
  if (nslots > slot_cap || nfix + spilled_cells > fix_cap) return 0;

  for (int64_t u = 0; u < nuniq; ++u) {
    const int64_t k = found[u].key;
    table.find(k).rank = static_cast<int32_t>(u);
    const int64_t s = k >> 28;
    const int64_t uvy = ((k >> 14) & 0x3fff) - (1 << 13);
    const int64_t uvx = (k & 0x3fff) - (1 << 13);
    const int32_t* q = qtab + ((uvy & 3) * 4 + (uvx & 3)) * 6;
    int32_t* row = uniq + u * 16;
    row[0] = static_cast<int32_t>(
        std::lower_bound(slot_list.begin(), slot_list.end(), s) -
        slot_list.begin());
    // arithmetic shifts and two's-complement masks, as numpy's >> and &
    // give them on negative MVs
    row[1] = static_cast<int32_t>(uvy >> 2);
    row[2] = static_cast<int32_t>(uvx >> 2);
    std::copy(q, q + 6, row + 3);
    row[9] = static_cast<int32_t>(uvy >> 3);
    row[10] = static_cast<int32_t>(uvx >> 3);
    row[11] = static_cast<int32_t>(uvy & 7);
    row[12] = static_cast<int32_t>(uvx & 7);
  }
  for (int64_t s = 0; s < nslots; ++s)
    slots[s] = static_cast<int32_t>(slot_list[s]);

  // buckets, and the fix-up cells in ascending order
  int64_t nf = 0, last_key = -1;
  int32_t last_rank = -1;
  for (int64_t i = 0; i < cells; ++i) {
    if (kind[i] == kNone) continue;
    int32_t r = -1;
    if (kind[i] == kFast) {
      if (key[i] != last_key) {
        last_key = key[i];
        last_rank = table.find(last_key).rank;
      }
      r = last_rank;
    }
    if (r >= 0)
      bucket[i] = static_cast<uint8_t>(r);
    else
      fix[nf++] = static_cast<int32_t>(i);
  }
  info[0] = 1;
  info[1] = static_cast<int32_t>(nuniq);
  info[2] = static_cast<int32_t>(nslots);
  return 0;
}

}  // extern "C"
