"""Intra predictors (torch, batched over a leading lane axis).

Port of losslessh264_tpu/ops/intra.py. Each predictor computes every
candidate mode for K lanes at once and the caller selects by mode index.
The JAX version builds each directional sample with its own scalar op
and vmaps over lanes; here each sample of the 4x4/8x8 directional modes
is one row of a static table over the lane's edge vector
e = [left..., top-left, top...]:

    pred = (w0*e[i0] + w1*e[i1] + w2*e[i2] + rnd) >> sh

(f3 = (a + 2b + c + 2) >> 2, f2 = (a + b + 1) >> 1, or a copy), so a
whole [K, 9, N, N] candidate stack is one gather and a few elementwise
ops. The tables are derived below from the spec's sample rules, written
as the JAX code writes them (8.3.1.2 / 8.3.2.2). Element-exact vs the
JAX predictors (tests/test_torch_intra.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .consts import on


def _f3(a, b, c):
    return (a, b, c, 1, 2, 1, 2, 2)


def _f2(a, b):
    return (a, b, a, 1, 1, 0, 1, 1)


def _cp(a):
    return (a, a, a, 1, 0, 0, 0, 0)


def _dir_table(N):
    """[9, N*N, 8] int32 rows (i0, i1, i2, w0, w1, w2, rnd, sh) over the
    edge vector [l0..l(N-1), tl, t0..t(2N-1)]. Mode 2 (DC) is a
    placeholder the caller overwrites."""
    l = list(range(N))
    tlv = N
    t = [N + 1 + i for i in range(2 * N)]
    modes = [[] for _ in range(9)]
    seq = [l[N - 1 - i] for i in range(N)] + [tlv] + t[:N]
    for y in range(N):
        for x in range(N):
            modes[0].append(_cp(t[x]))
            modes[1].append(_cp(l[y]))
            modes[2].append(_cp(tlv))
            # 3 DDL
            if x == N - 1 and y == N - 1:
                modes[3].append(_f3(t[2 * N - 2], t[2 * N - 1], t[2 * N - 1]))
            else:
                i = x + y
                modes[3].append(_f3(t[i], t[i + 1], t[i + 2]))
            # 4 DDR
            k = N + x - y
            modes[4].append(_f3(seq[k - 1], seq[k], seq[k + 1]))
            # 5 VR
            z = 2 * x - y
            if z >= 0 and z % 2 == 0:
                i = x - (y >> 1)
                a = tlv if i - 1 < 0 else t[i - 1]
                modes[5].append(_f2(a, t[i]))
            elif z >= 0:
                i = x - (y >> 1)
                a = tlv if i - 2 < 0 else t[i - 2]
                b = tlv if i - 1 < 0 else t[i - 1]
                modes[5].append(_f3(a, b, t[i]))
            elif z == -1:
                modes[5].append(_f3(l[0], tlv, t[0]))
            else:
                i = y - 2 * x - 1
                modes[5].append(
                    _f3(l[i], l[i - 1], l[i - 2] if i - 2 >= 0 else tlv)
                    if i >= 2 else _f3(l[1], l[0], tlv))
            # 6 HD
            z = 2 * y - x
            if z >= 0 and z % 2 == 0:
                i = y - (x >> 1)
                a = tlv if i - 1 < 0 else l[i - 1]
                modes[6].append(_f2(a, l[i]))
            elif z >= 0:
                i = y - (x >> 1)
                a = tlv if i - 2 < 0 else l[i - 2]
                b = tlv if i - 1 < 0 else l[i - 1]
                modes[6].append(_f3(a, b, l[i]))
            elif z == -1:
                modes[6].append(_f3(t[0], tlv, l[0]))
            else:
                i = x - 2 * y - 1
                modes[6].append(
                    _f3(t[i], t[i - 1], t[i - 2] if i - 2 >= 0 else tlv)
                    if i >= 2 else _f3(t[1], t[0], tlv))
            # 7 VL
            i = x + (y >> 1)
            modes[7].append(_f2(t[i], t[i + 1]) if y % 2 == 0
                            else _f3(t[i], t[i + 1], t[i + 2]))
            # 8 HU
            z = x + 2 * y
            if z > 2 * N - 3:
                modes[8].append(_cp(l[N - 1]))
            elif z == 2 * N - 3:
                modes[8].append(_f3(l[N - 2], l[N - 1], l[N - 1]))
            elif z % 2 == 0:
                i = y + (x >> 1)
                modes[8].append(_f2(l[i], l[i + 1]))
            else:
                i = y + (x >> 1)
                modes[8].append(_f3(l[i], l[i + 1], l[i + 2]))
    return np.asarray(modes, np.int32)


_TAB4 = _dir_table(4)
_TAB8 = _dir_table(8)


def _apply_table(e, tab, N):
    """e [K, E] int32 edge vectors -> [K, 9, N, N] table predictions."""
    tb = on(tab, e.device)
    g = e[:, tb[..., :3].long()]                           # [K, 9, NN, 3]
    v = (g * tb[..., 3:6]).sum(-1, dtype=torch.int32) + tb[..., 6]
    return (v >> tb[..., 7]).reshape(e.shape[0], 9, N, N)


def _dc(lsum, tsum, availL, availT, n_log2):
    """DC value with the spec's neighbour-availability rules."""
    both = (lsum + tsum + (1 << n_log2)) >> (n_log2 + 1)
    onlyl = (lsum + (1 << (n_log2 - 1))) >> n_log2
    onlyt = (tsum + (1 << (n_log2 - 1))) >> n_log2
    return torch.where(availL & availT, both,
                       torch.where(availL, onlyl,
                                   torch.where(availT, onlyt, 128)))


def pred4_all(left, top, tl, availL, availT):
    """left [K,4], top [K,8], tl [K], avail* [K] bool.
    Returns [K,9,4,4] int32 candidate predictions."""
    l = left.to(torch.int32)
    t = top.to(torch.int32)
    tlv = tl.to(torch.int32)
    out = _apply_table(torch.cat([l, tlv[:, None], t], 1), _TAB4, 4)
    dc = _dc(l.sum(1, dtype=torch.int32), t[:, :4].sum(1, dtype=torch.int32),
             availL, availT, 2)
    out[:, 2] = dc[:, None, None]
    return torch.clamp(out, 0, 255)


def pred8_all(left, top, tl, availL, availT, availTL):
    """8x8 intra with reference filtering (8.3.2.2.1). left [K,8],
    top [K,16], tl [K]. Returns [K,9,8,8]."""
    l = left.to(torch.int32)
    t = top.to(torch.int32)
    tlv = tl.to(torch.int32)
    ft0 = torch.where(availTL, (tlv + 2 * t[:, 0] + t[:, 1] + 2) >> 2,
                      (3 * t[:, 0] + t[:, 1] + 2) >> 2)
    ftm = (t[:, 0:14] + 2 * t[:, 1:15] + t[:, 2:16] + 2) >> 2
    ft15 = (t[:, 14] + 3 * t[:, 15] + 2) >> 2
    ft = torch.cat([ft0[:, None], ftm, ft15[:, None]], 1)
    ftl = torch.where(
        availL & availT, (l[:, 0] + 2 * tlv + t[:, 0] + 2) >> 2,
        torch.where(availT, (3 * tlv + t[:, 0] + 2) >> 2,
                    torch.where(availL, (3 * tlv + l[:, 0] + 2) >> 2, tlv)))
    ftl = torch.where(availTL, ftl, tlv)
    fl0 = torch.where(availTL, (tlv + 2 * l[:, 0] + l[:, 1] + 2) >> 2,
                      (3 * l[:, 0] + l[:, 1] + 2) >> 2)
    flm = (l[:, 0:6] + 2 * l[:, 1:7] + l[:, 2:8] + 2) >> 2
    fl7 = (l[:, 6] + 3 * l[:, 7] + 2) >> 2
    fl = torch.cat([fl0[:, None], flm, fl7[:, None]], 1)
    out = _apply_table(torch.cat([fl, ftl[:, None], ft], 1), _TAB8, 8)
    dc = _dc(fl.sum(1, dtype=torch.int32),
             ft[:, :8].sum(1, dtype=torch.int32), availL, availT, 3)
    out[:, 2] = dc[:, None, None]
    return torch.clamp(out, 0, 255)


def _plane_pred(left, top, tl, size):
    """Plane prediction (I16 mode 3 / chroma mode 3), [K,size,size]."""
    n = size
    h = n // 2
    dev = left.device
    idx = torch.arange(1, h + 1, device=dev)
    l = left.to(torch.int32)
    t = top.to(torch.int32)
    tlv = tl.to(torch.int32)[:, None]
    tpos = t[:, h - 1 + idx]
    tneg = torch.cat([t[:, h - 1 - idx[:-1]], tlv], 1)
    lpos = l[:, h - 1 + idx]
    lneg = torch.cat([l[:, h - 1 - idx[:-1]], tlv], 1)
    Hsum = (idx * (tpos - tneg)).sum(1, dtype=torch.int32)
    Vsum = (idx * (lpos - lneg)).sum(1, dtype=torch.int32)
    if n == 16:
        b = (5 * Hsum + 32) >> 6
        c = (5 * Vsum + 32) >> 6
    else:
        b = (17 * Hsum + 16) >> 5
        c = (17 * Vsum + 16) >> 5
    a = 16 * (l[:, n - 1] + t[:, n - 1])
    r = torch.arange(n, device=dev, dtype=torch.int32)
    val = (a[:, None, None] + b[:, None, None] * (r[None, None, :] - h + 1)
           + c[:, None, None] * (r[None, :, None] - h + 1) + 16) >> 5
    return torch.clamp(val, 0, 255)


def pred16_all(left, top, tl, availL, availT):
    """left/top [K,16], tl [K]. Returns [K,4,16,16] (V, H, DC, plane)."""
    l = left.to(torch.int32)
    t = top.to(torch.int32)
    K = l.shape[0]
    dc = _dc(l.sum(1, dtype=torch.int32), t.sum(1, dtype=torch.int32),
             availL, availT, 4)
    return torch.stack([t[:, None, :].expand(K, 16, 16),
                        l[:, :, None].expand(K, 16, 16),
                        dc[:, None, None].expand(K, 16, 16),
                        _plane_pred(left, top, tl, 16)], 1)


def pred_chroma_all(left, top, tl, availL, availT):
    """left/top [K,8], tl [K]. Returns [K,4,8,8] (DC, H, V, plane)."""
    l = left.to(torch.int32)
    t = top.to(torch.int32)
    K = l.shape[0]
    pred_dc = torch.zeros((K, 8, 8), dtype=torch.int32, device=l.device)
    for qy in range(2):
        for qx in range(2):
            ls = l[:, qy * 4:qy * 4 + 4].sum(1, dtype=torch.int32)
            ts = t[:, qx * 4:qx * 4 + 4].sum(1, dtype=torch.int32)
            if (qy, qx) in ((0, 0), (1, 1)):
                v = torch.where(
                    availL & availT, (ls + ts + 4) >> 3,
                    torch.where(availT, (ts + 2) >> 2,
                                torch.where(availL, (ls + 2) >> 2, 128)))
            elif (qy, qx) == (0, 1):
                v = torch.where(availT, (ts + 2) >> 2,
                                torch.where(availL, (ls + 2) >> 2, 128))
            else:
                v = torch.where(availL, (ls + 2) >> 2,
                                torch.where(availT, (ts + 2) >> 2, 128))
            pred_dc[:, qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = \
                v[:, None, None]
    return torch.stack([pred_dc,
                        l[:, :, None].expand(K, 8, 8),
                        t[:, None, :].expand(K, 8, 8),
                        _plane_pred(left, top, tl, 8)], 1)


# 4x4 block decode order within an MB (raster index per step)
BLK_ORDER = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15])
