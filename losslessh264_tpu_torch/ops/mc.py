"""Motion compensation (torch, batched) and the K1 half-pel kernel wrapper.

Port of losslessh264_tpu/ops/mc.py: quarter-pel 6-tap luma and
eighth-pel bilinear chroma, per 4x4 cell (general path) and as the
bucketed dense-shift fast path over precomputed half-pel planes.
Element-exact vs decoder_np.mc_luma_block / mc_chroma_block.

`halfpel_planes` is the wrapper of the hand-written CUDA kernel
csrc/halfpel.cu (it replaces the Pallas kernel `halfpel_planes_pallas`,
losslessh264_tpu/ops/mc.py:144); `halfpel_planes_plain` is its plain
torch version, which the wrapper takes for a CPU tensor only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .consts import on


def _sixtap(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def _window_gather(ref_stack, r, y, x, rows, cols):
    """[B, rows, cols] int32 windows of ref_stack [R, Hp, Wp] at
    per-cell (slot r, top-left y, x) — one flat batched gather."""
    R, Hp, Wp = ref_stack.shape
    dev = ref_stack.device
    oy = torch.arange(rows, device=dev)
    ox = torch.arange(cols, device=dev)
    idx = ((r * Hp + y)[:, None, None] + oy[None, :, None]) * Wp \
        + x[:, None, None] + ox[None, None, :]
    return ref_stack.reshape(-1)[idx.long()].to(torch.int32)


def mc_luma_cells(ref_stack, pad, ref_idx, y0, x0, mvx, mvy):
    """ref_stack [R, H+2p, W+2p] uint8; per-cell vectors [B]. Returns
    [B,4,4] int32 predicted samples."""
    h = w = 4
    R, Hp, Wp = ref_stack.shape
    H = Hp - 2 * pad
    W = Wp - 2 * pad
    r = ref_idx.to(torch.int32)
    cy = y0.to(torch.int32)
    cx = x0.to(torch.int32)
    vx = mvx.to(torch.int32)
    vy = mvy.to(torch.int32)
    # reference BaseMC clips iFullMV into the padded window (rec_mb.cpp:
    # CLIP3 to [(-PADDING_LENGTH+2)<<2, (dim+PADDING_LENGTH-19)<<2]); the
    # clip keeps every 9x9 window inside the padded plane
    fullx = torch.clamp((cx << 2) + vx, (-pad + 2) << 2, (W + pad - 19) << 2)
    fully = torch.clamp((cy << 2) + vy, (-pad + 2) << 2, (H + pad - 19) << 2)
    ix = fullx >> 2
    iy = fully >> 2
    fx = (fullx & 3)[:, None, None]
    fy = (fully & 3)[:, None, None]
    win = _window_gather(ref_stack, r, pad + iy - 2, pad + ix - 2,
                         h + 5, w + 5)                      # [B, 9, 9]

    G = win[:, 2:2 + h, 2:2 + w]
    b_full = _sixtap(win[:, :, 0:w], win[:, :, 1:w + 1], win[:, :, 2:w + 2],
                     win[:, :, 3:w + 3], win[:, :, 4:w + 4],
                     win[:, :, 5:w + 5])                    # [B, 9, 4]
    b = torch.clamp((b_full[:, 2:2 + h] + 16) >> 5, 0, 255)
    h_full = _sixtap(win[:, 0:h], win[:, 1:h + 1], win[:, 2:h + 2],
                     win[:, 3:h + 3], win[:, 4:h + 4], win[:, 5:h + 5])
    hh = torch.clamp((h_full[:, :, 2:2 + w] + 16) >> 5, 0, 255)
    j_full = _sixtap(b_full[:, 0:h], b_full[:, 1:h + 1], b_full[:, 2:h + 2],
                     b_full[:, 3:h + 3], b_full[:, 4:h + 4],
                     b_full[:, 5:h + 5])
    j = torch.clamp((j_full + 512) >> 10, 0, 255)
    G1 = win[:, 2:2 + h, 3:3 + w]
    H1 = win[:, 3:3 + h, 2:2 + w]
    b1 = torch.clamp((b_full[:, 3:3 + h] + 16) >> 5, 0, 255)
    hh1 = torch.clamp((h_full[:, :, 3:3 + w] + 16) >> 5, 0, 255)

    W_ = torch.where
    bb = W_(fy == 1, b, b1)          # nearest b row for quarter-diag
    hhh = W_(fx == 1, hh, hh1)
    case_fy0 = W_(fx == 0, G, W_(fx == 1, (G + b + 1) >> 1,
                                 W_(fx == 2, b, (G1 + b + 1) >> 1)))
    case_fx0 = W_(fy == 1, (G + hh + 1) >> 1,
                  W_(fy == 2, hh, (H1 + hh + 1) >> 1))
    case_fx2 = W_(fy == 2, j, W_(fy == 1, (b + j + 1) >> 1,
                                 (b1 + j + 1) >> 1))
    case_fy2 = W_(fx == 1, (hh + j + 1) >> 1, (hh1 + j + 1) >> 1)
    diag = (bb + hhh + 1) >> 1
    return W_(fy == 0, case_fy0,
              W_(fx == 0, case_fx0,
                 W_(fx == 2, case_fx2, W_(fy == 2, case_fy2, diag))))


def mc_chroma_cells(ref_stack, pad, ref_idx, y0, x0, mvx, mvy):
    """Chroma 2x2 cells from [R, H/2+2p, W/2+2p]. Returns [B,2,2] int32."""
    h = w = 2
    R, Hp, Wp = ref_stack.shape
    Hc = Hp - 2 * pad
    Wc = Wp - 2 * pad
    lpad = 2 * pad
    r = ref_idx.to(torch.int32)
    cy = y0.to(torch.int32)
    cx = x0.to(torch.int32)
    vx = mvx.to(torch.int32)
    vy = mvy.to(torch.int32)
    # shared luma-unit iFullMV clip, then >>3 (rec_mb.cpp BaseMC)
    fullx = torch.clamp(((2 * cx) << 2) + vx, (-lpad + 2) << 2,
                        (2 * Wc + lpad - 19) << 2)
    fully = torch.clamp(((2 * cy) << 2) + vy, (-lpad + 2) << 2,
                        (2 * Hc + lpad - 19) << 2)
    ix = fullx >> 3
    iy = fully >> 3
    fx = (fullx & 7)[:, None, None]
    fy = (fully & 7)[:, None, None]
    win = _window_gather(ref_stack, r, pad + iy, pad + ix, h + 1, w + 1)
    A = win[:, 0:h, 0:w]
    B = win[:, 0:h, 1:w + 1]
    C = win[:, 1:h + 1, 0:w]
    D = win[:, 1:h + 1, 1:w + 1]
    return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
            (8 - fx) * fy * C + fx * fy * D + 32) >> 6


def mc_luma_mbs(planes, pad, y0, x0, mvx, mvy, size=16):
    """Whole-block quarter-pel luma prediction from the half-pel planes
    [4, Hp, Wp] (K1's output for a pad-padded reference; size 16 = MBs,
    8 = P8x8 partitions). Each of a block's two taps is a [size, size]
    window of one plane whose start is clamped into the plane, as the
    JAX function clamps it (torch would read out of range). Returns
    [n, size, size] int32, equal to mc_luma_cells for MVs that keep the
    window inside the planes."""
    _, Hp, Wp = planes.shape
    dev = planes.device
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    e = on(QTAB, dev)[((mvy & 3) * 4 + (mvx & 3)).long()]
    by = pad - 2 + y0.to(torch.int32) + (mvy >> 2)
    bx = pad - 2 + x0.to(torch.int32) + (mvx >> 2)
    o = torch.arange(size, device=dev)
    flat = planes.reshape(-1)

    def samp(p, dy, dx):
        yy = torch.clamp(by + dy, 0, Hp - size).long()
        xx = torch.clamp(bx + dx, 0, Wp - size).long()
        idx = ((p.long() * Hp + yy)[:, None, None] + o[None, :, None]) \
            * Wp + xx[:, None, None] + o[None, None, :]
        return flat[idx].to(torch.int32)

    t1 = samp(e[:, 0], e[:, 1], e[:, 2])
    t2 = samp(e[:, 3], e[:, 4], e[:, 5])
    return (t1 + t2 + 1) >> 1


def mc_chroma_mbs(ref_pad_c, pad, cy0, cx0, mvx, mvy, size=8):
    """Whole-block chroma prediction from one edge-padded plane
    [Hc, Wc]: one window gather per block, the MV uniform across it
    (size 8 = an MB's chroma, 4 = a P8x8 quadrant's). Window starts are
    clamped into the plane, as the JAX function clamps them. Returns
    [B, size, size] int32."""
    S = size
    Hc, Wc = ref_pad_c.shape
    dev = ref_pad_c.device
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    iy = torch.clamp(pad + cy0.to(torch.int32) + (mvy >> 3), 0, Hc - (S + 1))
    ix = torch.clamp(pad + cx0.to(torch.int32) + (mvx >> 3), 0, Wc - (S + 1))
    o = torch.arange(S + 1, device=dev)
    win = ref_pad_c[(iy[:, None, None] + o[None, :, None]).long(),
                    (ix[:, None, None] + o[None, None, :]).long()] \
        .to(torch.int32)
    fx = (mvx & 7)[:, None, None]
    fy = (mvy & 7)[:, None, None]
    A = win[:, 0:S, 0:S]
    B = win[:, 0:S, 1:S + 1]
    C = win[:, 1:S + 1, 0:S]
    D = win[:, 1:S + 1, 1:S + 1]
    return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
            (8 - fx) * fy * C + fx * fy * D + 32) >> 6


# ---------------------------------------------------------------------------
# K1: the four half-pel planes of one padded reference
# ---------------------------------------------------------------------------
def halfpel_planes_plain(ref_pad):
    """Plain torch version of K1. ref_pad: [Hp, Wp] uint8/int32
    edge-padded reference plane. Returns [4, Hp-5, Wp-5] int32 (G, b, h,
    j) aligned so reference position (y, x) maps to planes[:, y-2, x-2]:
    G = integer samples, b = (y, x+1/2), h = (y+1/2, x), j = both."""
    r = ref_pad.to(torch.int32)
    bf = _sixtap(r[:, 0:-5], r[:, 1:-4], r[:, 2:-3], r[:, 3:-2], r[:, 4:-1],
                 r[:, 5:])                              # [Hp, Wp-5] < 2^14
    b = torch.clamp((bf + 16) >> 5, 0, 255)
    hf = _sixtap(r[0:-5, :], r[1:-4, :], r[2:-3, :], r[3:-2, :], r[4:-1, :],
                 r[5:, :])                              # [Hp-5, Wp]
    h = torch.clamp((hf + 16) >> 5, 0, 255)
    jf = _sixtap(bf[0:-5], bf[1:-4], bf[2:-3], bf[3:-2], bf[4:-1], bf[5:])
    j = torch.clamp((jf + 512) >> 10, 0, 255)           # [Hp-5, Wp-5]
    return torch.stack([r[2:-3, 2:-3], b[2:-3, :], h[:, 2:-3], j])


def _pitch(Wo):
    """Row pitch of the uint8 planes: Wo rounded up to 16 bytes, so the
    kernel stores aligned words."""
    return (Wo + 15) // 16 * 16


def _halfpel_launch(ref_pad, out_dtype):
    if ref_pad.device.type != "cuda":
        raise ValueError("halfpel kernel takes CUDA tensors, got "
                         f"{ref_pad.device}")
    if ref_pad.dtype != torch.uint8 or ref_pad.dim() != 2:
        raise ValueError("halfpel kernel takes a 2-D uint8 plane, got "
                         f"{tuple(ref_pad.shape)} {ref_pad.dtype}")
    Hp, Wp = ref_pad.shape
    if Hp < 6 or Wp < 6:
        raise ValueError(f"plane {Hp}x{Wp} is smaller than the 6-tap")
    src = ref_pad.contiguous()
    Ho, Wo = Hp - 5, Wp - 5
    P = ctypes.c_void_p
    if out_dtype == torch.int32:
        out = torch.empty((4, Ho, Wo), dtype=torch.int32, device=src.device)
        rc = _build.lib().pip_halfpel_i32(
            P(src.data_ptr()), P(out.data_ptr()), Hp, Wp,
            _build.stream(src.device))
    else:
        out = torch.empty((4, Ho, _pitch(Wo)), dtype=torch.uint8,
                          device=src.device)
        rc = _build.lib().pip_halfpel_u8_pitched(
            P(src.data_ptr()), P(out.data_ptr()), Hp, Wp, out.stride(1),
            _build.stream(src.device))
        out = out[..., :Wo]
    _build.check(rc, "halfpel")
    _build.count_launch(halfpel_planes)
    return out


def halfpel_planes(ref_pad):
    """K1 wrapper: [Hp, Wp] uint8 plane -> [4, Hp-5, Wp-5] int32 planes
    (the JAX kernel's output contract). CPU tensors take the plain
    version; CUDA tensors launch csrc/halfpel.cu."""
    if ref_pad.device.type == "cpu":
        return halfpel_planes_plain(ref_pad)
    return _halfpel_launch(ref_pad, torch.int32)


halfpel_planes.launches = 0


def _halfpel_planes_u8(ref_pad):
    """The same planes as uint8 (every value is 0..255): the internal
    entry mc_bucketed uses, a quarter of the int32 output's bytes. The
    result is the [4, Hp-5, Wp-5] view of [4, Hp-5, pitch] planes whose
    rows are padded to 16 bytes (_pitch), on the CPU as on the card."""
    if ref_pad.device.type == "cpu":
        Hp, Wp = ref_pad.shape
        out = torch.empty((4, Hp - 5, _pitch(Wp - 5)), dtype=torch.uint8)
        out[..., :Wp - 5] = halfpel_planes_plain(ref_pad)
        return out[..., :Wp - 5]
    return _halfpel_launch(ref_pad, torch.uint8)


# ---------------------------------------------------------------------------
# Bucketed dense-shift MC (decoder fast path). Real P frames cluster
# around few distinct (ref, mv) values, and for one (ref, mv) the whole
# prediction is an affine read of a half-pel plane: build G/b/h/j for
# the (<=2) active reference slots once per frame, then for each unique
# (slot, mv) triple take two shifted dense slices, average per the
# spec's quarter-pel rules (QTAB), and select per pixel by a bucket
# plane. Cells the dense path cannot serve exactly get a per-cell
# fix-up gather. The plan (mc_fast_plan) is host numpy, copied verbatim
# from losslessh264_tpu/ops/mc.py, whose module imports jax.
# ---------------------------------------------------------------------------
# quarter-pel case tables: k = (mvy&3)*4 + (mvx&3) selects two plane
# samples whose rounded average is the predicted value (planes G=0, b=1,
# h=2, j=3; identical-pair entries are the pure G/b/h/j cases since
# (2a+1)>>1 == a). Derived from the spec 8.4.2.2.1 quarter-sample rules
# (same math as mc_luma_cells above).
QTAB = np.array(
    #  p1 dy1 dx1  p2 dy2 dx2        k = fy*4+fx
    [[0, 0, 0, 0, 0, 0],   # 0  (0,0) G
     [0, 0, 0, 1, 0, 0],   # 1  (0,1) (G+b)/2
     [1, 0, 0, 1, 0, 0],   # 2  (0,2) b
     [0, 0, 1, 1, 0, 0],   # 3  (0,3) (G(x+1)+b)/2
     [0, 0, 0, 2, 0, 0],   # 4  (1,0) (G+h)/2
     [1, 0, 0, 2, 0, 0],   # 5  (1,1) (b+h)/2
     [1, 0, 0, 3, 0, 0],   # 6  (1,2) (b+j)/2
     [1, 0, 0, 2, 0, 1],   # 7  (1,3) (b+h(x+1))/2
     [2, 0, 0, 2, 0, 0],   # 8  (2,0) h
     [2, 0, 0, 3, 0, 0],   # 9  (2,1) (h+j)/2
     [3, 0, 0, 3, 0, 0],   # 10 (2,2) j
     [2, 0, 1, 3, 0, 0],   # 11 (2,3) (h(x+1)+j)/2
     [0, 1, 0, 2, 0, 0],   # 12 (3,0) (G(y+1)+h)/2
     [1, 1, 0, 2, 0, 0],   # 13 (3,1) (b(y+1)+h)/2
     [1, 1, 0, 3, 0, 0],   # 14 (3,2) (b(y+1)+j)/2
     [1, 1, 0, 2, 0, 1]],  # 15 (3,3) (b(y+1)+h(x+1))/2
    np.int32)

MC_CAP = 32        # unique (slot, mv) triples served by the fast path
MC_SLOT_CAP = 2    # active reference slots served by the fast path
MC_FIX_CAP = 512   # per-cell fix-ups (clipped/out-of-range/spilled cells)
MC_MV_MAX = 112    # |mv| quarter-pels the dense slices can shift


def mc_fast_plan(mb_w, mb_h, ref_slot, mv, pad):
    """Host-side fast-path plan (numpy). Returns a dict of plan arrays
    (always the same shapes, so scanned runs can stack them) with
    plan["mc_fast"] False when the frame exceeds the caps and must take
    the general per-cell branch."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    rs = ref_slot.reshape(-1).astype(np.int64)
    vx = mv[:, :, 0].reshape(-1).astype(np.int64)
    vy = mv[:, :, 1].reshape(-1).astype(np.int64)
    valid = rs >= 0

    mbi = np.arange(n)
    cell = np.arange(16)
    cy0 = ((mbi // mb_w)[:, None] * 16 + (cell // 4)[None, :] * 4) \
        .reshape(-1)
    cx0 = ((mbi % mb_w)[:, None] * 16 + (cell % 4)[None, :] * 4) \
        .reshape(-1)
    # cells where the reference-style iFullMV clip engages (the chroma
    # clip bound reduces to the same inequality: cell coords are 4-px
    # aligned and lpad == 2*(pad//2) == pad)
    lo = (-pad + 2) << 2
    fullx = (cx0 << 2) + vx
    fully = (cy0 << 2) + vy
    clip = ((fullx < lo) | (fullx > ((W + pad - 19) << 2))
            | (fully < lo) | (fully > ((H + pad - 19) << 2)))
    big = (np.abs(vx) > MC_MV_MAX) | (np.abs(vy) > MC_MV_MAX)
    fix = valid & (clip | big)
    fast = valid & ~fix

    plan = {
        "mc_fast": np.bool_(False),
        "mc_nuniq": np.int32(0),
        "mc_uniq": np.zeros((MC_CAP, 16), np.int32),
        "mc_slots": np.zeros((MC_SLOT_CAP,), np.int32),
        "mc_nslots": np.int32(0),
        "mc_bucket": np.full((n, 16), MC_CAP, np.uint8),
        "mc_fix": np.full((MC_FIX_CAP,), -1, np.int32),
    }
    if not valid.any():
        return plan      # nothing to predict: either branch is fine
    key = ((rs << 28) + ((vy + (1 << 13)) << 14) + (vx + (1 << 13)))
    # MB-uniform reduction: most MBs carry one (slot, mv) for all 16
    # cells, so unique() runs over ~n keys instead of 16n
    kg = key.reshape(-1, 16)
    fg = fast.reshape(-1, 16)
    uni = ((kg == kg[:, :1]).all(axis=1) & fg.all(axis=1))
    redu = np.concatenate([kg[uni, 0], kg[~uni][fg[~uni]]])
    uk = np.unique(redu)
    nuni = int(uni.sum())
    # cell counts: a uniform MB contributes 16 cells per key
    cnt = np.bincount(np.searchsorted(uk, redu),
                      weights=np.where(np.arange(len(redu)) < nuni,
                                       16, 1),
                      minlength=len(uk)).astype(np.int64)
    inv = np.searchsorted(uk, key[fast])
    slots = np.unique(rs[fast]) if fast.any() else np.zeros(0, np.int64)
    if len(uk) > MC_CAP:
        # serve the MC_CAP most-populated triples densely; spill the
        # long tail's cells to the per-cell fix-up gather
        keep = np.argsort(-cnt)[:MC_CAP]
        keep_mask = np.zeros(len(uk), bool)
        keep_mask[keep] = True
        spill = np.zeros(len(fast), bool)
        spill[fast] = ~keep_mask[inv]
        fix |= spill
        fast &= ~spill
        uk, inv = np.unique(key[fast], return_inverse=True)
        slots = np.unique(rs[fast]) if fast.any() else \
            np.zeros(0, np.int64)
    if (len(uk) > MC_CAP or len(slots) > MC_SLOT_CAP
            or int(fix.sum()) > MC_FIX_CAP):
        return plan
    slot_local = {int(s): i for i, s in enumerate(slots)}
    uniq = np.zeros((MC_CAP, 16), np.int32)
    for u, k in enumerate(uk):
        s = int(k >> 28)
        uvy = int(((k >> 14) & 0x3fff) - (1 << 13))
        uvx = int((k & 0x3fff) - (1 << 13))
        q = QTAB[(uvy & 3) * 4 + (uvx & 3)]
        uniq[u, 0] = slot_local[s]
        uniq[u, 1] = uvy >> 2
        uniq[u, 2] = uvx >> 2
        uniq[u, 3:9] = q
        uniq[u, 9] = uvy >> 3
        uniq[u, 10] = uvx >> 3
        uniq[u, 11] = uvy & 7
        uniq[u, 12] = uvx & 7
    bucket = np.full(n * 16, MC_CAP, np.uint8)
    bucket[fast] = inv.astype(np.uint8)
    fx_list = np.flatnonzero(fix)
    mc_fix = np.full((MC_FIX_CAP,), -1, np.int32)
    mc_fix[:len(fx_list)] = fx_list
    plan.update(
        mc_fast=np.bool_(True),
        mc_nuniq=np.int32(len(uk)),
        mc_uniq=uniq,
        mc_slots=np.concatenate(
            [slots, np.zeros(MC_SLOT_CAP - len(slots), np.int64)]
        ).astype(np.int32),
        mc_nslots=np.int32(len(slots)),
        mc_bucket=bucket.reshape(n, 16),
        mc_fix=mc_fix)
    return plan


def _check_window(y, x, rows, cols, plane_shape, what):
    """JAX's lax.dynamic_slice clamps a start that would run past the
    plane; the plan's caps (|mv| <= MC_MV_MAX with PAD = 32) keep every
    slice in range, so the port checks that instead of clamping."""
    Hs, Ws = plane_shape
    if not (0 <= y and y + rows <= Hs and 0 <= x and x + cols <= Ws):
        raise ValueError(f"{what} slice at ({y}, {x}) size {rows}x{cols} "
                         f"leaves the {Hs}x{Ws} plane")


def _drop_scatter(plane, idx, vals):
    """plane.reshape(-1)[idx] = vals with idx == plane.numel() dropped."""
    H, W = plane.shape
    flat = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
    flat[idx.reshape(-1)] = vals.reshape(-1).to(plane.dtype)
    return flat[:H * W].reshape(H, W)


def mc_bucketed(ref_y, ref_u, ref_v, pad, p, mb_w, mb_h):
    """Whole-frame pred planes from the plan built by mc_fast_plan.
    Returns (pred_y [H,W], pred_u, pred_v [H/2,W/2]) int32.

    p: the frame's plane dict. "mc_uniq"/"mc_slots" are host numpy (they
    drive host-side slicing), "mc_nuniq"/"mc_nslots" host ints; the
    rest are tensors on the rings' device."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    R, Hp, Wp = ref_y.shape
    dev = ref_y.device
    uniq = np.asarray(p["mc_uniq"]).astype(np.int64)
    slots = np.asarray(p["mc_slots"]).astype(np.int64)
    nuniq = int(p["mc_nuniq"])
    nslots = int(p["mc_nslots"])
    if not (0 <= slots.min() and slots.max() < R):
        raise ValueError(f"mc slots {slots} outside the {R}-slot ring")

    # half-pel planes for the active slots (slot 1 reuses slot 0's when
    # inactive), kept as uint8
    hp0 = _halfpel_planes_u8(ref_y[int(slots[0])])
    hps = [hp0, _halfpel_planes_u8(ref_y[int(slots[1])])
           if nslots > 1 else hp0]
    cpad = pad // 2
    uvs = [torch.stack([ref_u[int(s)], ref_v[int(s)]]) for s in slots]
    if nslots <= 1:
        uvs[1] = uvs[0]

    # bucket planes (cell = 4x4 luma px, 2x2 chroma px)
    bg = p["mc_bucket"].reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3) \
        .reshape(mb_h * 4, mb_w * 4)
    bplane = bg.repeat_interleave(4, 0).repeat_interleave(4, 1)
    bplane_c = bg.repeat_interleave(2, 0).repeat_interleave(2, 1)

    out_y = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    out_uv = torch.zeros((2, H // 2, W // 2), dtype=torch.uint8, device=dev)
    for u in range(nuniq):
        e = [int(v) for v in uniq[u]]
        hp = hps[e[0]]

        def tap(pl, dy, dx):
            y = pad - 2 + e[1] + dy
            x = pad - 2 + e[2] + dx
            _check_window(y, x, H, W, hp.shape[1:], "half-pel")
            return hp[pl, y:y + H, x:x + W].to(torch.int32)

        val = ((tap(e[3], e[4], e[5]) + tap(e[6], e[7], e[8]) + 1) >> 1)
        out_y = torch.where(bplane == u, val.to(torch.uint8), out_y)

        uv = uvs[e[0]]

        def ctap(dy, dx):
            y = cpad + e[9] + dy
            x = cpad + e[10] + dx
            _check_window(y, x, H // 2, W // 2, uv.shape[1:], "chroma")
            return uv[:, y:y + H // 2, x:x + W // 2].to(torch.int32)

        fy, fx = e[11], e[12]
        cval = ((8 - fx) * (8 - fy) * ctap(0, 0)
                + fx * (8 - fy) * ctap(0, 1)
                + (8 - fx) * fy * ctap(1, 0)
                + fx * fy * ctap(1, 1) + 32) >> 6
        out_uv = torch.where(bplane_c[None] == u, cval.to(torch.uint8),
                             out_uv)

    # per-cell fix-ups (clipped / long MVs): general gather on at most
    # MC_FIX_CAP cells, scattered over the dense planes
    fixi = p["mc_fix"].to(torch.int64)
    fmask = fixi >= 0
    fc = torch.clamp(fixi, 0, n * 16 - 1)
    fmb, fcell = fc // 16, fc % 16
    fy0 = (fmb // mb_w) * 16 + (fcell // 4) * 4
    fx0 = (fmb % mb_w) * 16 + (fcell % 4) * 4
    rsl = torch.clamp(p["ref_slot"].reshape(-1).to(torch.int64)[fc], 0,
                      R - 1)
    fvx = p["mv"][:, :, 0].reshape(-1)[fc]
    fvy = p["mv"][:, :, 1].reshape(-1)[fc]
    tiles = mc_luma_cells(ref_y, pad, rsl, fy0, fx0, fvx, fvy)
    o4 = torch.arange(4, device=dev)
    flatidx = torch.where(
        fmask[:, None, None],
        (fy0[:, None, None] + o4[None, :, None]) * W
        + fx0[:, None, None] + o4[None, None, :], H * W)
    out_y = _drop_scatter(out_y, flatidx, tiles)
    o2 = torch.arange(2, device=dev)
    cflat = torch.where(
        fmask[:, None, None],
        (fy0[:, None, None] // 2 + o2[None, :, None]) * (W // 2)
        + fx0[:, None, None] // 2 + o2[None, None, :],
        (H // 2) * (W // 2))
    planes = []
    for c, ref_c in enumerate((ref_u, ref_v)):
        ct = mc_chroma_cells(ref_c, cpad, rsl, fy0 // 2, fx0 // 2, fvx, fvy)
        planes.append(_drop_scatter(out_uv[c], cflat, ct))
    return (out_y.to(torch.int32), planes[0].to(torch.int32),
            planes[1].to(torch.int32))
