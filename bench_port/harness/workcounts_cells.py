"""The work of K11, the per-cell motion compensation of a frame the
bucketed plan does not serve, and the least time the card could take for
it: bytes are the inputs the frame's prediction depends on, each read
once, and the outputs written once, as workcounts.k6_reads counts K6's
fix-up cells; operations count at the int32 rate.

Every inter cell (ref_slot 0 or more) reads its ref_slot and MV; the
luma samples of its 9x9 window that its quarter-pel case reads
(workcounts.k6_luma_need) and the 2x2 to 3x3 chroma samples of its
eighth-pel case, U and V alike, each sample counted once however many
cells' windows hold it; on a frame with weighted prediction its three
(w, o, d) triples and its MB's chroma mask. Every cell's ref_slot is
read, and the three int32 prediction planes are written once.
"""
from __future__ import annotations

import numpy as np

from . import workcounts as wc

# a cell's luma window samples by quarter-pel case: [16 (fy * 4 + fx), 9, 9]
_NEED = wc.k6_luma_need(np.tile(np.arange(4), 4), np.repeat(np.arange(4), 4))


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def k11_reads(ref_shape, refu_shape, pad, p, mb_w, mb_h):
    """(luma, chroma, inter cells): the ring samples the frame's per-cell
    prediction under the plane dict `p` depends on, as bool masks of the
    rings' shapes (chroma U's, V alike), and the number of inter cells."""
    H, W = 16 * mb_h, 16 * mb_w
    R = ref_shape[0]
    cpad = pad // 2
    lpad = 2 * cpad
    Hc, Wc = H // 2, W // 2
    rs = _host(p["ref_slot"]).reshape(-1).astype(np.int64)
    cells = np.flatnonzero(rs >= 0)
    mb, k = cells // 16, cells % 16
    y0 = (mb // mb_w) * 16 + (k // 4) * 4
    x0 = (mb % mb_w) * 16 + (k % 4) * 4
    slot = np.clip(rs[cells], 0, R - 1)
    mv = _host(p["mv"]).reshape(-1, 2)[cells].astype(np.int64)
    vx, vy = mv[:, 0], mv[:, 1]
    fullx = np.clip(4 * x0 + vx, (2 - pad) * 4, (W + pad - 19) * 4)
    fully = np.clip(4 * y0 + vy, (2 - pad) * 4, (H + pad - 19) * 4)
    b, r, c = np.nonzero(_NEED[(fully & 3) * 4 + (fullx & 3)])
    luma = np.zeros(ref_shape, bool)
    luma[slot[b], pad + (fully[b] >> 2) - 2 + r,
         pad + (fullx[b] >> 2) - 2 + c] = True
    cfx = np.clip(4 * x0 + vx, (2 - lpad) * 4, (2 * Wc + lpad - 19) * 4)
    cfy = np.clip(4 * y0 + vy, (2 - lpad) * 4, (2 * Hc + lpad - 19) * 4)
    fy, fx = cfy & 7, cfx & 7
    o3 = np.arange(3)
    keep = ((o3[None, :, None] < 2 + (fy > 0)[:, None, None])
            & (o3[None, None, :] < 2 + (fx > 0)[:, None, None]))
    ys = np.broadcast_to((cpad + (cfy >> 3))[:, None, None]
                         + o3[None, :, None], keep.shape)
    xs = np.broadcast_to((cpad + (cfx >> 3))[:, None, None]
                         + o3[None, None, :], keep.shape)
    ss = np.broadcast_to(slot[:, None, None], keep.shape)
    chroma = np.zeros(refu_shape, bool)
    chroma[ss[keep], ys[keep], xs[keep]] = True
    return luma, chroma, len(cells)


def k11_bytes_ops(ref_shape, refu_shape, pad, p, mb_w, mb_h):
    """(bytes, operations) K11 must take for the frame's plane dict `p` on
    rings of these shapes. Operations: an inter cell's luma pixel
    K1_OPS_PER_POSITION, its chroma pixels 9 each (as a K6 fix-up
    cell's)."""
    H, W = 16 * mb_h, 16 * mb_w
    n = mb_w * mb_h
    luma, chroma, cells = k11_reads(ref_shape, refu_shape, pad, p, mb_w,
                                    mb_h)
    n_bytes = (16 * n * p["ref_slot"].element_size()
               + cells * 2 * p["mv"].element_size()
               + int(luma.sum()) + 2 * int(chroma.sum()) + 6 * H * W)
    if "wp_luma" in p:
        n_bytes += cells * 3 * 3 * p["wp_luma"].element_size() + 64 * n
    return n_bytes, cells * (16 * wc.K1_OPS_PER_POSITION + 2 * 4 * 9)

