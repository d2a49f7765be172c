"""Motion estimation for the encoder (torch, batched over the frame).

Port of losslessh264_tpu/ops/me.py: the dense integer-pel search, the
quadrant-granular quarter-pel refinement and the intra cost proxy (the
fused encoder path), the per-block window search of the older encoder
(`full_search_sad`), and the per-block sub-pel refinements
(`subpel_refine`, `subpel_full`). Every running best of
the JAX code keeps its first minimum (a strict `<` in candidate order);
here a whole batch of candidates is reduced at once with torch.min /
torch.argmin along the candidate axis, which also return the first
minimum, and batches are visited in the JAX order. Element-exact vs the
JAX functions (tests/test_torch_me.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .consts import on
from .mc import QTAB


def _blocks_hw(block):
    return (block, block) if isinstance(block, int) else tuple(block)


def _clamped_windows(plane, y, x, rows, cols):
    """[n, ..., rows, cols] windows of `plane` [..., Hp, Wp] at per-block
    starts (y, x) as JAX's dynamic_slice takes them: a negative start
    counts from the end (start + dim), then the start is clamped into the
    plane (torch would read out of range instead)."""
    Hp, Wp = plane.shape[-2:]
    dev = plane.device
    y = y.to(torch.int64)
    x = x.to(torch.int64)
    y = torch.clamp(torch.where(y < 0, y + Hp, y), 0, Hp - rows)
    x = torch.clamp(torch.where(x < 0, x + Wp, x), 0, Wp - cols)
    oy = torch.arange(rows, device=dev)
    ox = torch.arange(cols, device=dev)
    w = plane[..., (y[:, None, None] + oy[None, :, None]),
              (x[:, None, None] + ox[None, None, :])]
    return w.movedim(-3, 0) if plane.dim() == 3 else w


def full_search_sad(cur_mbs, ref_pad, mb_y, mb_x, radius=16, block=16):
    """Exhaustive integer-pel block search, one window per block.

    cur_mbs: [n, bh, bw] int source blocks; block = side length or a
    (bh, bw) pair (16 MBs, 8 P8x8 partitions, (8, 16) / (16, 8)).
    ref_pad: reference luma edge-padded by `radius` on every side.
    mb_y/mb_x: [n] top-left pixel coords of each block (unpadded frame).
    Each block's [2R+bh, 2R+bw] window starts at (mb_y, mb_x) of ref_pad,
    a negative start wrapped and every start clamped into the plane, as
    JAX's dynamic_slice takes them (_clamped_windows). The SADs are int32
    sums of int16 differences (JAX builds its patches in float32, which
    is exact for bytes); displacements are visited row by row and each
    row's minimum is the first, so the winner is the first minimum of
    the raster (dy, dx) order, JAX's argmin over the flattened window.
    Returns (best_dy, best_dx, best_sad, zero_sad), [n] int32 each,
    offsets in integer pixels relative to the colocated position."""
    bh, bw = _blocks_hw(block)
    span = 2 * radius + 1
    n = cur_mbs.shape[0]
    dev = cur_mbs.device
    win = _clamped_windows(ref_pad.to(torch.int16), mb_y, mb_x,
                           2 * radius + bh, 2 * radius + bw)
    cur16 = cur_mbs.to(torch.int16)[:, :, None, :]     # [n, bh, 1, bw]
    best_sad = torch.full((n,), 1 << 30, dtype=torch.int32, device=dev)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    zero_sad = None
    for dy in range(span):
        # the row's span horizontal shifts: [n, bh, span, bw]
        pat = win[:, dy:dy + bh].unfold(2, bw, 1)
        sads = torch.abs(pat - cur16).sum((1, 3), dtype=torch.int32)
        if dy == radius:
            zero_sad = sads[:, radius]
        smin, sarg = torch.min(sads, 1)                 # first minimum
        better = smin < best_sad
        best_sad = torch.where(better, smin, best_sad)
        best_idx = torch.where(better, dy * span + sarg.to(torch.int32),
                               best_idx)
    return (best_idx // span - radius, best_idx % span - radius, best_sad,
            zero_sad)


@functools.lru_cache(maxsize=None)
def _refine_taps(step, SH, SW):
    """Flat indices into a per-block [4, SH+2, SW+2] window of the two
    plane taps of every candidate of subpel_refine: [bases, 9, 2, SH,
    SW] (one base for step 2, four for step 1: fractional parts (0, 0),
    (0, 2), (2, 0), (2, 2)), and the 9 offsets (oy, ox) oy-major."""
    bases = [(0, 0)] if step == 2 else [(0, 0), (0, 2), (2, 0), (2, 2)]
    offs = [(oy, ox) for oy in (-step, 0, step) for ox in (-step, 0, step)]
    h, w = SH + 2, SW + 2
    y = np.arange(SH)[:, None]
    x = np.arange(SW)[None, :]
    taps = np.zeros((len(bases), len(offs), 2, SH, SW), np.int64)
    for b, (bfy, bfx) in enumerate(bases):
        for i, (oy, ox) in enumerate(offs):
            k = ((bfy + oy) & 3) * 4 + ((bfx + ox) & 3)
            p1, dy1, dx1, p2, dy2, dx2 = (int(v) for v in QTAB[k])
            ry = 1 + ((bfy + oy) >> 2)
            rx = 1 + ((bfx + ox) >> 2)
            taps[b, i, 0] = p1 * h * w + (ry + dy1 + y) * w + rx + dx1 + x
            taps[b, i, 1] = p2 * h * w + (ry + dy2 + y) * w + rx + dx2 + x
    return taps, np.array(offs, np.int32)


def subpel_refine(planes, pad, mb_y, mb_x, mvx, mvy, cur_mbs, step,
                  size=16, return_pred=False):
    """One sub-pel refinement round (step=2: half-pel, step=1: quarter).

    planes: [4, Hp-5, Wp-5] half-pel planes of a pad-padded reference.
    Per block, ONE [4, SH+2, SW+2] window around the current integer
    position (its start taken as JAX's dynamic_slice takes it:
    _clamped_windows); each of the 9 candidates (offsets of `step`
    quarter-pels, oy-major) is the rounded average of two static slices
    of it. Entering
    step=1 the fractional MV parts are in {0, 2}, and each block takes
    the one base case its own MV selects (bidx = fy/2 * 2 + fx/2), as
    JAX selects it, computing only that base's candidates. The first
    minimum wins. Returns (mvx, mvy, best_sad) per block, and with
    return_pred the winning [SH, SW] prediction (int32) as well."""
    SH, SW = _blocks_hw(size)
    n = cur_mbs.shape[0]
    dev = cur_mbs.device
    taps, offs = _refine_taps(step, SH, SW)
    vx = mvx.to(torch.int32)
    vy = mvy.to(torch.int32)
    win = _clamped_windows(planes.to(torch.int32),
                           pad - 3 + mb_y.to(torch.int32) + (vy >> 2),
                           pad - 3 + mb_x.to(torch.int32) + (vx >> 2),
                           SH + 2, SW + 2).reshape(n, -1)
    bidx = (torch.zeros_like(vx) if step == 2
            else ((vy & 2) >> 1) * 2 + ((vx & 2) >> 1))
    t = on(taps, dev)[bidx.long()]                     # [n, 9, 2, SH, SW]
    rows = torch.arange(n, device=dev)[:, None, None, None]
    pred = (win[rows, t[:, :, 0]] + win[rows, t[:, :, 1]] + 1) >> 1
    sads = torch.abs(pred - cur_mbs.to(torch.int32)[:, None]) \
        .sum((2, 3), dtype=torch.int32)                # [n, 9]
    best_sad, best = torch.min(sads, 1)                # first minimum
    o = on(offs, dev)
    out = (vx + o[best, 1], vy + o[best, 0], best_sad)
    if return_pred:
        out += (pred[torch.arange(n, device=dev), best],)
    return out


def _gather_index(i, dim):
    """An index array as JAX's array indexing takes it: a negative index
    counts from the end (i + dim), and the gather clamps the result into
    [0, dim - 1]."""
    return torch.clamp(torch.where(i < 0, i + dim, i), 0, dim - 1)


@functools.lru_cache(maxsize=None)
def _full_taps(SH, SW):
    """Flat indices into a per-block [4, SH+3, SW+3] window of the two
    plane taps of each of subpel_full's 49 candidates (ty-major):
    [49, 2, SH, SW]."""
    h, w = SH + 3, SW + 3
    y = np.arange(SH)[:, None]
    x = np.arange(SW)[None, :]
    taps = np.zeros((len(_OFFS), 2, SH, SW), np.int64)
    for i, (ty, tx) in enumerate(_OFFS):
        p1, dy1, dx1, p2, dy2, dx2 = (int(v) for v in
                                      QTAB[(ty & 3) * 4 + (tx & 3)])
        ry = 2 + (ty >> 2)
        rx = 2 + (tx >> 2)
        taps[i, 0] = p1 * h * w + (ry + dy1 + y) * w + rx + dx1 + x
        taps[i, 1] = p2 * h * w + (ry + dy2 + y) * w + rx + dx2 + x
    return taps


def subpel_full(planes, pad, mb_y, mb_x, mvx, mvy, cur_blks, size=16):
    """Full 7x7 quarter-pel refinement around an integer-pel winner.

    One [4, SH+3, SW+3] window per block; all 49 candidates (ty, tx in
    -3..3, ty-major) are rounded averages of two static slices of it,
    and the first minimum wins. JAX gathers the window with per-element
    indices, as numpy indexing takes them: a negative index counts from
    the end, and its gather clamps the result into the planes; the port
    takes each index the same way (_gather_index). mvx/mvy: integer-pel
    winners in quarter units (frac == 0). Returns (mvx, mvy, sad, pred) with pred
    the [n, SH, SW] int32 prediction of the winning MV."""
    SH, SW = _blocks_hw(size)
    n = cur_blks.shape[0]
    dev = cur_blks.device
    _, Hq, Wq = planes.shape
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    ys = (pad - 4 + mb_y.to(torch.int32) + (mvy >> 2)).long()
    xs = (pad - 4 + mb_x.to(torch.int32) + (mvx >> 2)).long()
    iy = _gather_index(ys[:, None] + torch.arange(SH + 3, device=dev), Hq)
    ix = _gather_index(xs[:, None] + torch.arange(SW + 3, device=dev), Wq)
    win = planes.to(torch.int16)[:, iy[:, :, None], ix[:, None, :]]
    win = win.permute(1, 0, 2, 3).reshape(n, -1)       # [n, 4*(SH+3)*(SW+3)]
    taps = on(_full_taps(SH, SW), dev)
    cand = (win[:, taps[:, 0]] + win[:, taps[:, 1]] + 1) >> 1  # [n,49,SH,SW]
    sad = torch.abs(cand - cur_blks.to(torch.int16)[:, None]) \
        .sum((2, 3), dtype=torch.int32)
    best_sad, best_t = torch.min(sad, 1)
    best_t = best_t.to(torch.int32)
    pred = cand[torch.arange(n, device=dev), best_t.long()].to(torch.int32)
    return mvx + best_t % 7 - 3, mvy + best_t // 7 - 3, best_sad, pred


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
