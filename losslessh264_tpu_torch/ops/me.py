"""Motion estimation for the encoder (torch, batched over the frame).

Port of the functions of losslessh264_tpu/ops/me.py that the encoder's
fused path calls: the dense integer-pel search, the quadrant-granular
quarter-pel refinement and the intra cost proxy. Every running best of
the JAX code keeps its first minimum (a strict `<` in candidate order);
here a whole batch of candidates is reduced at once with torch.min /
torch.argmin along the candidate axis, which also return the first
minimum, and batches are visited in the JAX order. Element-exact vs the
JAX functions (tests/test_torch_me.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .consts import on
from .mc import QTAB


def _pool8(d, h8, w8):
    """[C, H, W] -> [C, h8, w8] int32 sums over 8x8 blocks."""
    C = d.shape[0]
    return d.reshape(C, h8, 8, w8, 8).sum((2, 4), dtype=torch.int32)


def dense_full_search(cur, ref_pad, radius):
    """Exhaustive integer-pel search over every displacement in
    [-radius, radius]^2, for every 16x16, 16x8, 8x16 and 8x8 block of
    the frame at once.

    cur: [H, W] int source luma (16 | H, W). ref_pad: [H+2R, W+2R]
    edge-padded reference. Displacements are visited row by row (dy,
    then dx), as JAX visits them; each row's 2R+1 shifts are one batch.
    Returns four (dy, dx, sad) triples, flattened raster-MB-major: 16x16
    [n], 16x8 [2n] (top, bottom), 8x16 [2n] (left, right), 8x8 [4n]
    (row-major quadrants)."""
    H, W = cur.shape
    span = 2 * radius + 1
    h8, w8 = H // 8, W // 8
    mbh, mbw = h8 // 2, w8 // 2
    dev = cur.device
    cur16 = cur.to(torch.int16)
    ref16 = ref_pad.to(torch.int16)
    dx = torch.arange(span, device=dev, dtype=torch.int32)
    # running (sad, displacement index) per block shape, init (INF, 0)
    best = [[torch.full(s, 1 << 30, dtype=torch.int32, device=dev),
             torch.zeros(s, dtype=torch.int32, device=dev)]
            for s in ((mbh, mbw), (h8, mbw), (mbh, w8), (h8, w8))]
    for dy in range(span):
        # the row's 2R+1 horizontal shifts as one [span, H, W] view
        shifts = ref16[dy:dy + H].unfold(1, W, 1).permute(1, 0, 2)
        s8 = _pool8(torch.abs(cur16[None] - shifts), h8, w8)
        sh2 = s8[:, :, 0::2] + s8[:, :, 1::2]      # 16 wide, 8 high
        sv2 = s8[:, 0::2] + s8[:, 1::2]            # 8 wide, 16 high
        s16 = sh2[:, 0::2] + sh2[:, 1::2]
        for b, s in zip(best, (s16, sh2, sv2, s8)):
            smin, sarg = torch.min(s, 0)           # first minimum over dx
            better = smin < b[0]
            b[0] = torch.where(better, smin, b[0])
            b[1] = torch.where(better, dy * span + dx[sarg], b[1])

    def unpack(b, flat):
        sad, idx = b
        return (flat(idx // span - radius), flat(idx % span - radius),
                flat(sad))

    def f16(a):
        return a.reshape(-1)

    def fh(a):
        return a.reshape(mbh, 2, mbw).permute(0, 2, 1).reshape(-1)

    def f8(a):
        return a.reshape(mbh, 2, mbw, 2).permute(0, 2, 1, 3).reshape(-1)

    return (unpack(best[0], f16), unpack(best[1], fh),
            unpack(best[2], f16), unpack(best[3], f8))


# the 49 quarter-pel offsets (ty, tx) of subpel_quad, ty-major, and for
# each the flat index into a [4, 11, 11] window of its two plane taps per
# pixel of the 8x8 block: candidate = (win[i1] + win[i2] + 1) >> 1
_OFFS = [(ty, tx) for ty in range(-3, 4) for tx in range(-3, 4)]


def _quad_taps():
    y = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    taps = np.zeros((2, len(_OFFS), 8, 8), np.int64)
    for i, (ty, tx) in enumerate(_OFFS):
        p1, dy1, dx1, p2, dy2, dx2 = (int(v) for v in
                                      QTAB[(ty & 3) * 4 + (tx & 3)])
        ry = 2 + (ty >> 2)
        rx = 2 + (tx >> 2)
        taps[0, i] = p1 * 121 + (ry + dy1 + y) * 11 + rx + dx1 + x
        taps[1, i] = p2 * 121 + (ry + dy2 + y) * 11 + rx + dx2 + x
    return taps


_QUAD_TAPS = _quad_taps()
_OFFS_T = np.array(_OFFS, np.int32)   # [49, 2] (ty, tx)


def subpel_quad(planes, pad, by8, bx8, mvx, mvy, src8, part):
    """Quadrant-granular joint quarter-pel refinement.

    planes: [4, Hp-5, Wp-5] half-pel planes (K1's output, any integer
    dtype). by8/bx8: [4n] quadrant pixel coords. mvx/mvy: [4n] integer
    winners in quarter units of the chosen partition per quadrant;
    part: [n] 0/1/2/3 = P16x16/P16x8/P8x16/P8x8. All 49 candidates of
    the 7x7 quarter grid are built at once from one [4, 11, 11] window
    per quadrant; each candidate's quadrant SADs are pooled into the
    chosen partition's units and every unit keeps its first best.
    Windows stay inside the planes for |mv| <= 16 px with pad 32 (the
    encoder's search radius), so no start is clamped.
    Returns (mvqx, mvqy, sad_tot [n], pred_q [4n, 8, 8] int32)."""
    m = src8.shape[0]
    n = m // 4
    dev = src8.device
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    ys = (pad - 4 + by8 + (mvy >> 2)).long()
    xs = (pad - 4 + bx8 + (mvx >> 2)).long()
    o = torch.arange(11, device=dev)
    win = planes[:, ys[:, None, None] + o[None, :, None],
                 xs[:, None, None] + o[None, None, :]]      # [4, m, 11, 11]
    win = win.permute(1, 0, 2, 3).reshape(m, 4 * 121).to(torch.int16)
    taps = on(_QUAD_TAPS, dev)
    cand = (win[:, taps[0]] + win[:, taps[1]] + 1) >> 1     # [m, 49, 8, 8]
    qsad = torch.abs(cand - src8.to(torch.int16)[:, None]) \
        .sum((2, 3), dtype=torch.int32).reshape(n, 4, len(_OFFS))

    # pool into the chosen partition's units, per quadrant lane
    q = torch.arange(4, device=dev)
    s16 = qsad.sum(1, keepdim=True).expand(n, 4, len(_OFFS))
    sh = qsad.reshape(n, 2, 2, -1).sum(2)[:, q // 2]          # (01)(23)
    sv = qsad.reshape(n, 2, 2, -1).sum(1)[:, q % 2]           # (02)(13)
    pn = part.to(torch.int64)[:, None, None]
    usad = torch.where(pn == 1, sh, s16)
    usad = torch.where(pn == 2, sv, usad)
    usad = torch.where(pn == 3, qsad, usad)
    best_usad, best_i = torch.min(usad, 2)                   # [n, 4]
    lanes_per_unit = torch.where(
        pn[:, :, 0] == 0, 4, torch.where(pn[:, :, 0] == 3, 1, 2))
    sad_tot = (best_usad // lanes_per_unit).sum(1, dtype=torch.int32)

    t_q = best_i.reshape(m)
    offs = on(_OFFS_T, dev)
    pred_q = cand[torch.arange(m, device=dev), t_q].to(torch.int32)
    return (mvx + offs[t_q, 1], mvy + offs[t_q, 0], sad_tot, pred_q)


def intra_sad_proxy(cur_mbs):
    """Cheap intra cost: SAD of each [16,16] MB to its rounded mean."""
    c = cur_mbs.to(torch.int32)
    mean = (c.sum((1, 2), keepdim=True, dtype=torch.int32) + 128) // 256
    return torch.abs(c - mean).sum((1, 2), dtype=torch.int32)
