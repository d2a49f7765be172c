"""Numpy tables and host functions the port keeps as pinned copies.

Copies of what the port uses from losslessh264_tpu/decoder_np.py, so
that the port imports nothing of the JAX package: the dequantisation
and deblocking tables, the scaling-list weights, SPS cropping, the
per-MB error concealment (a rare host path, so it stays numpy) with the
block MC it calls, and the per-block inverse transforms, dequantisation
and plane prediction that the older encoder's host loops reconstruct
with (losslessh264_tpu_torch/encoder.py). tests/test_torch_ref_np.py
and tests/test_torch_encoder_basic.py (the older encoder's names) pin
every name here to its original.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------
CHROMA_QP = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
     20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33, 34, 34,
     35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39], np.int32)

# 4x4 dequant: V4[qp%6][position class] (spec 8.5.12.1)
V4 = np.array([[10, 16, 13], [11, 18, 14], [13, 20, 16],
               [14, 23, 18], [16, 25, 20], [18, 29, 23]], np.int32)
POS4 = np.array([[0 if (i % 2 == 0 and j % 2 == 0)
                  else 1 if (i % 2 == 1 and j % 2 == 1) else 2
                  for j in range(4)] for i in range(4)], np.int32)


def _pos8(i, j):
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


# 8x8 dequant: V8[qp%6][position class] (spec 8.5.12.1)
V8 = np.array([[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26],
               [26, 23, 42, 24, 33, 31], [28, 25, 45, 26, 35, 33],
               [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]], np.int32)
POS8 = np.array([[_pos8(i, j) for j in range(8)] for i in range(8)],
                np.int32)

# scaling lists are stored in zigzag order
ZZ4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
ZZ8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# deblocking thresholds (spec 8.7.2.2, tables 8-16 and 8-17)
ALPHA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8, 9, 10,
     12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90,
     101, 113, 127, 144, 162, 182, 203, 226, 255, 255], np.int32)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3, 3, 4,
     4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14,
     15, 15, 16, 16, 17, 17, 18, 18], np.int32)
TC0_TABLE = np.array([
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 1],
    [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1], [1, 1, 1],
    [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2], [1, 1, 2],
    [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4], [2, 3, 4],
    [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7], [4, 5, 8],
    [5, 6, 9], [6, 7, 10], [6, 8, 11], [7, 9, 12], [8, 10, 13], [9, 12, 15],
    [10, 13, 17], [11, 16, 20], [13, 18, 23], [14, 20, 25]], np.int32)


# default (flat) weight = 16 when no scaling lists
FLAT4 = np.full(16, 16, np.int32)


def weights4(scaling_row):
    """A zigzag-ordered 4x4 scaling list as a [4, 4] weight block."""
    w = np.zeros(16, np.int32)
    w[ZZ4] = scaling_row
    return w.reshape(4, 4)


def weights8(scaling_row):
    """A zigzag-ordered 8x8 scaling list as an [8, 8] weight block."""
    w = np.zeros(64, np.int32)
    w[ZZ8] = scaling_row
    return w.reshape(8, 8)


def crop_yuv(yuv, crop_px):
    """Apply SPS frame cropping (l, r, t, b luma samples) to a decoded
    (Y, U, V) tuple: what the reference decoder writes as its output."""
    l, r, t, b = crop_px
    Y, U, V = yuv
    H, W = Y.shape
    return (Y[t:H - b, l:W - r],
            U[t // 2:(H - b) // 2, l // 2:(W - r) // 2],
            V[t // 2:(H - b) // 2, l // 2:(W - r) // 2])


# ---------------------------------------------------------------------------
# per-block inverse transforms and dequantisation (the older encoder)
# ---------------------------------------------------------------------------
def idct4(b):
    b = b.astype(np.int64)
    e0 = b[0] + b[2]
    e1 = b[0] - b[2]
    e2 = (b[1] >> 1) - b[3]
    e3 = b[1] + (b[3] >> 1)
    return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3])


def idct4x4(blk):
    """[4, 4] dequantized coefficients -> rounded residual."""
    h = idct4(blk.T).T  # rows
    v = idct4(h)
    return (v + 32) >> 6


def hadamard4x4(blk):
    def h1(a):
        e0 = a[0] + a[2]
        e1 = a[0] - a[2]
        e2 = a[1] - a[3]
        e3 = a[1] + a[3]
        return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3])

    return h1(h1(blk.T.astype(np.int64)).T)


def dequant4(coeff, qp, weights):
    """Spec 8.5.9 with LevelScale4x4 = weight * V4."""
    qp = int(qp)
    ls = weights * V4[qp % 6][POS4]
    if qp >= 24:
        return (coeff.astype(np.int64) * ls) << (qp // 6 - 4)
    shift = 4 - qp // 6
    return (coeff.astype(np.int64) * ls + (1 << (shift - 1))) >> shift


def luma_dc_dequant(dc_t, qp, weights):
    """Spec 8.5.10, after the inverse Hadamard."""
    qp = int(qp)
    scale = int(weights[0, 0]) * int(V4[qp % 6][0])
    if qp >= 36:
        return (dc_t * scale) << (qp // 6 - 6)
    shift = 6 - qp // 6
    return (dc_t * scale + (1 << (shift - 1))) >> shift


def chroma_dc_dequant(dc_t, qp, weights):
    """Spec 8.5.11: ((f * LevelScale(qp % 6, 0, 0)) << (qp / 6)) >> 5."""
    scale = int(weights[0, 0]) * int(V4[qp % 6][0])
    return ((dc_t * scale) << (qp // 6)) >> 5


def plane_pred(left, top, topleft, size, xy_shift):
    """Spec plane prediction for 16x16 luma (size 16) or 8x8 chroma
    (size 8)."""
    n = size
    h = n // 2
    Hsum = 0
    Vsum = 0
    for i in range(1, h + 1):
        Hsum += i * (int(top[h - 1 + i]) - (int(topleft) if i == h
                                            else int(top[h - 1 - i])))
        Vsum += i * (int(left[h - 1 + i]) - (int(topleft) if i == h
                                             else int(left[h - 1 - i])))
    if n == 16:
        b = (5 * Hsum + 32) >> 6
        c = (5 * Vsum + 32) >> 6
    else:
        b = (17 * Hsum + 16) >> 5
        c = (17 * Vsum + 16) >> 5
    a = 16 * (int(left[n - 1]) + int(top[n - 1]))
    ys, xs = np.mgrid[0:n, 0:n]
    val = (a + b * (xs - h + 1) + c * (ys - h + 1) + 16) >> 5
    return np.clip(val, 0, 255)


# ---------------------------------------------------------------------------
# block MC (concealment, and the older encoder's chroma prediction)
# ---------------------------------------------------------------------------
def _sixtap(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def mc_luma_block(ref_pad, pad, y0, x0, mvx, mvy, h, w):
    """Quarter-pel luma MC of one h x w block from an edge-padded
    reference (pad offset), the full-pel position clipped into the padded
    window as the reference decoder does (rec_mb.cpp BaseMC)."""
    W = ref_pad.shape[1] - 2 * pad
    H = ref_pad.shape[0] - 2 * pad
    fullx = min(max((x0 << 2) + mvx, (-pad + 2) << 2), (W + pad - 19) << 2)
    fully = min(max((y0 << 2) + mvy, (-pad + 2) << 2), (H + pad - 19) << 2)
    ix, iy = fullx >> 2, fully >> 2
    fx, fy = fullx & 3, fully & 3
    # window with the 6-tap margin: rows iy-2..iy+h+2, cols ix-2..ix+w+2
    win = ref_pad[pad + iy - 2: pad + iy + h + 3,
                  pad + ix - 2: pad + ix + w + 3].astype(np.int32)
    G = win[2:2 + h, 2:2 + w]
    if fx == 0 and fy == 0:
        return G
    b_full = _sixtap(win[:, 0:w + 0], win[:, 1:w + 1], win[:, 2:w + 2],
                     win[:, 3:w + 3], win[:, 4:w + 4], win[:, 5:w + 5])
    b = np.clip((b_full[2:2 + h] + 16) >> 5, 0, 255)
    h_full = _sixtap(win[0:h + 0, :], win[1:h + 1, :], win[2:h + 2, :],
                     win[3:h + 3, :], win[4:h + 4, :], win[5:h + 5, :])
    hh = np.clip((h_full[:, 2:2 + w] + 16) >> 5, 0, 255)
    j_full = _sixtap(b_full[0:h + 0], b_full[1:h + 1], b_full[2:h + 2],
                     b_full[3:h + 3], b_full[4:h + 4], b_full[5:h + 5])
    j = np.clip((j_full + 512) >> 10, 0, 255)
    G1 = win[2:2 + h, 3:3 + w]   # right
    H1 = win[3:3 + h, 2:2 + w]   # below
    b1 = np.clip((b_full[3:3 + h] + 16) >> 5, 0, 255)       # b one row below
    hh1 = np.clip((h_full[:, 3:3 + w] + 16) >> 5, 0, 255)   # h one col right
    if fy == 0:
        return {1: (G + b + 1) >> 1, 2: b, 3: (G1 + b + 1) >> 1}[fx]
    if fx == 0:
        return {1: (G + hh + 1) >> 1, 2: hh, 3: (H1 + hh + 1) >> 1}[fy]
    if fx == 2 and fy == 2:
        return j
    if fx == 2:
        return (b + j + 1) >> 1 if fy == 1 else (b1 + j + 1) >> 1
    if fy == 2:
        return (hh + j + 1) >> 1 if fx == 1 else (hh1 + j + 1) >> 1
    # quarter diagonal: average of the nearest b and h
    bb = b if fy == 1 else b1
    hhh = hh if fx == 1 else hh1
    return (bb + hhh + 1) >> 1


def mc_chroma_block(ref_pad, pad, y0, x0, mvx, mvy, h, w):
    """Eighth-pel bilinear chroma MC (chroma plane coordinates, mv in
    luma quarter-pels), with the reference's luma-unit clip first."""
    Wc = ref_pad.shape[1] - 2 * pad
    Hc = ref_pad.shape[0] - 2 * pad
    lpad = 2 * pad
    fullx = min(max(((2 * x0) << 2) + mvx, (-lpad + 2) << 2),
                (2 * Wc + lpad - 19) << 2)
    fully = min(max(((2 * y0) << 2) + mvy, (-lpad + 2) << 2),
                (2 * Hc + lpad - 19) << 2)
    ix, iy = fullx >> 3, fully >> 3
    fx, fy = fullx & 7, fully & 7
    win = ref_pad[pad + iy: pad + iy + h + 1,
                  pad + ix: pad + ix + w + 1].astype(np.int32)
    A = win[0:h, 0:w]
    B = win[0:h, 1:w + 1]
    C = win[1:h + 1, 0:w]
    D = win[1:h + 1, 1:w + 1]
    return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
            (8 - fx) * fy * C + fx * fy * D + 32) >> 6


# ---------------------------------------------------------------------------
# error concealment of undecoded MBs
# ---------------------------------------------------------------------------
def conceal_undecoded(f, yuv, prev, prev_idx, ec_mode):
    """Per-MB concealment of the MBs with f["decoded"] == 0. prev: the
    previous output frame of the same size, or None; prev_idx: its
    decode-order index. ec_mode "mv_copy_freeze" takes MV copy, any other
    slice copy."""
    if ec_mode == "mv_copy_freeze":
        return conceal_mv_copy(f, yuv, prev, prev_idx)
    return conceal_slice_copy(f, yuv, prev)


def _fill_mb(planes, src, my, mx):
    """Copy MB (my, mx) of src into planes (Y, U, V), or mid-gray when
    src is None."""
    for k, t in ((0, 16), (1, 8), (2, 8)):
        sl = (slice(my * t, my * t + t), slice(mx * t, mx * t + t))
        planes[k][sl] = 128 if src is None else src[k][sl]


def conceal_slice_copy(f, yuv, prev):
    """Slice-copy concealment (reference ERROR_CON_SLICE_COPY): each lost
    MB takes the co-located pixels of the previous output frame, or
    mid-gray when there is none."""
    out = tuple(a.copy() for a in yuv)
    for mbi in np.flatnonzero(f["decoded"] == 0):
        _fill_mb(out, prev, *divmod(int(mbi), f["mb_w"]))
    return out


def conceal_mv_copy(f, yuv, prev, prev_idx):
    """MV-copy concealment (reference DoErrorConSliceMVCopy,
    GetAvilInfoFromCorrectMb, DoMbECMvCopy): average the MVs of the
    correctly decoded inter MBs per ref_idx (one sample per
    motion-partition top-left cell, C-truncating division), then
    motion-compensate each lost MB 16x16 from the previous picture with
    that MV, clamped to the picture interior. Lost MBs with no usable
    MV take the co-located copy, or mid-gray without a previous frame."""
    out = tuple(a.copy() for a in yuv)
    undec = np.flatnonzero(f["decoded"] == 0)
    mb_w = f["mb_w"]
    if prev is None:
        for mbi in undec:
            _fill_mb(out, None, *divmod(int(mbi), mb_w))
        return out
    Y, U, V = out
    W, H = Y.shape[1], Y.shape[0]
    ok_inter = (f["decoded"] != 0) & np.isin(
        f["mb_class"], [3, 4, 5, 6, 7, 11])
    sel = f["part_tl"].astype(bool) & ok_inter[:, None]
    ridx = f["ref_idx"]
    ecmv = {}
    for r in np.unique(ridx[sel]):
        m = sel & (ridx == r)
        cnt = int(m.sum())
        sx = int(f["mv"][:, :, 0][m].astype(np.int64).sum())
        sy = int(f["mv"][:, :, 1][m].astype(np.int64).sum())
        # C integer division truncates toward zero
        ecmv[int(r)] = (int(sx / cnt), int(sy / cnt))
    ref_list = f.get("ref_list") or []
    use_copy = (f["is_idr"] or 0 not in ecmv or not ref_list)
    if not use_copy:
        mvx, mvy = ecmv[0]
        if ref_list[0] != prev_idx:
            # POC scaling, with the output index as the affine proxy
            s0 = ref_list[0] - (prev_idx + 1)
            s1 = prev_idx - (prev_idx + 1)
            mvx = 0 if s0 == 0 else int(mvx * s1 / s0)
            mvy = 0 if s0 == 0 else int(mvy * s1 / s0)
    pY, pU, pV = (np.pad(a, 4, mode="edge") for a in prev)
    for mbi in undec:
        my, mx = divmod(int(mbi), mb_w)
        if use_copy:
            _fill_mb(out, prev, my, mx)
            continue
        sy, sx = my * 16, mx * 16
        fx = (sx << 2) + mvx
        fy = (sy << 2) + mvy
        if fx < 2 << 2:
            fx = max(0, (fx >> 2) << 2)
        elif fx > (W - 19) << 2:
            fx = min((W - 17) << 2, (fx >> 2) << 2)
        if fy < 2 << 2:
            fy = max(0, (fy >> 2) << 2)
        elif fy > (H - 19) << 2:
            fy = min((H - 17) << 2, (fy >> 2) << 2)
        cmvx, cmvy = fx - (sx << 2), fy - (sy << 2)
        Y[sy:sy + 16, sx:sx + 16] = mc_luma_block(
            pY, 4, sy, sx, cmvx, cmvy, 16, 16)
        U[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = mc_chroma_block(
            pU, 4, my * 8, mx * 8, cmvx, cmvy, 8, 8)
        V[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = mc_chroma_block(
            pV, 4, my * 8, mx * 8, cmvx, cmvy, 8, 8)
    return out
