"""Dequantization and inverse transforms (torch, batched over the frame).

Decode half of losslessh264_tpu/ops/transform.py: the same integer math
on [..., 4, 4] / [..., 8, 8] blocks, all in int32. The JAX package's
position-major variants exist for the TPU's lane layout; here the plain
block layout is kept, and the tests pin both to the same results.
Reference: decode_mb_aux.cpp IdctResAddPred_c / IdctResAddPred8x8,
WelsLumaDcDequantIdct, decode_slice.cpp WelsChromaDcIdct.
"""
from __future__ import annotations

import numpy as np
import torch

from losslessh264_tpu import decoder_np as _np_ref

DEQ4_V = np.asarray(_np_ref._V4[:, _np_ref._POS4], np.int32)      # [6,4,4]
DEQ8_V = np.asarray(_np_ref._V8[:, _np_ref._POS8], np.int32)      # [6,8,8]
CHROMA_QP = np.asarray(_np_ref.CHROMA_QP, np.int32)


def _round_shift(c, shift):
    """(c + (1 << max(shift - 1, 0))) >> shift, elementwise int32."""
    one = torch.ones_like(shift)
    return (c + (one << torch.clamp(shift - 1, min=0))) >> shift


def _dequant(coeff, qp, weights, deq, qshift):
    qp = qp.to(torch.int32)
    deq_t = torch.as_tensor(deq, device=coeff.device)
    ls = weights.to(torch.int32) * deq_t[(qp % 6).long()]
    c = coeff.to(torch.int32) * ls
    qdiv = (qp // 6)[..., None, None]
    hi = c << torch.clamp(qdiv - qshift, min=0)
    lo = _round_shift(c, torch.clamp(qshift - qdiv, min=0))
    return torch.where(qdiv >= qshift, hi, lo)


def dequant4(coeff, qp, weights):
    """coeff [..,4,4] int, qp [..] int, weights [..,4,4] (16 = flat).
    Returns dequantized int32 levels (spec 8.5.9 general form)."""
    return _dequant(coeff, qp, weights, DEQ4_V, 4)


def dequant8(coeff, qp, weights):
    """coeff [..,8,8], qp [..], weights [..,8,8]."""
    return _dequant(coeff, qp, weights, DEQ8_V, 6)


def _idct4_1d(a0, a1, a2, a3):
    e0 = a0 + a2
    e1 = a0 - a2
    e2 = (a1 >> 1) - a3
    e3 = a1 + (a3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def idct4x4(blocks):
    """[..,4,4] dequantized int32 -> residual int32 (incl. (x+32)>>6)."""
    b = blocks.to(torch.int32)
    h = torch.stack(_idct4_1d(b[..., 0], b[..., 1], b[..., 2], b[..., 3]),
                    dim=-1)
    v = torch.stack(_idct4_1d(h[..., 0, :], h[..., 1, :], h[..., 2, :],
                              h[..., 3, :]), dim=-2)
    return (v + 32) >> 6


def hadamard4x4(dc):
    """Inverse 4x4 Hadamard for I16 luma DC. [..,4,4] -> [..,4,4]."""
    b = dc.to(torch.int32)

    def h1_last(a):
        e0 = a[..., 0] + a[..., 2]
        e1 = a[..., 0] - a[..., 2]
        e2 = a[..., 1] - a[..., 3]
        e3 = a[..., 1] + a[..., 3]
        return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)

    return h1_last(h1_last(b).transpose(-1, -2)).transpose(-1, -2)


def idct8x8(blocks):
    """[..,8,8] dequantized -> residual (spec 8.5.12.2)."""
    b = blocks.to(torch.int32)

    def core_last(a):
        a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        a4, a5, a6, a7 = a[..., 4], a[..., 5], a[..., 6], a[..., 7]
        e0 = a0 + a4
        e1 = -a3 + a5 - a7 - (a7 >> 1)
        e2 = a0 - a4
        e3 = a1 + a7 - a3 - (a3 >> 1)
        e4 = (a2 >> 1) - a6
        e5 = -a1 + a7 + a5 + (a5 >> 1)
        e6 = a2 + (a6 >> 1)
        e7 = a3 + a5 + a1 + (a1 >> 1)
        f0 = e0 + e6
        f1 = e1 + (e7 >> 2)
        f2 = e2 + e4
        f3 = e3 + (e5 >> 2)
        f4 = e2 - e4
        f5 = (e3 >> 2) - e5
        f6 = e0 - e6
        f7 = e7 - (e1 >> 2)
        return torch.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                            f6 - f1, f4 - f3, f2 - f5, f0 - f7], dim=-1)

    v = core_last(core_last(b).transpose(-1, -2))
    return (v.transpose(-1, -2) + 32) >> 6


def luma_dc_dequant(dc_t, qp, w00):
    """Post-Hadamard I16 DC dequant (8.5.10). dc_t [..,4,4], qp [..]."""
    qp = qp.to(torch.int32)
    deq00 = torch.as_tensor(DEQ4_V[:, 0, 0], device=dc_t.device)
    deq00 = deq00[(qp % 6).long()]
    scale = (w00 * deq00)[..., None, None]
    qdiv = (qp // 6)[..., None, None]
    hi = (dc_t * scale) << torch.clamp(qdiv - 6, min=0)
    lo = _round_shift(dc_t * scale, torch.clamp(6 - qdiv, min=0))
    return torch.where(qdiv >= 6, hi, lo)


def chroma_dc_transform_dequant(dc, qpc, w00):
    """2x2 inverse Hadamard + dequant (8.5.11). dc [..,2,2], qpc [..]."""
    a = dc[..., 0, 0].to(torch.int32)
    b = dc[..., 0, 1].to(torch.int32)
    c = dc[..., 1, 0].to(torch.int32)
    d = dc[..., 1, 1].to(torch.int32)
    t = torch.stack([torch.stack([a + b + c + d, a - b + c - d], -1),
                     torch.stack([a + b - c - d, a - b - c + d], -1)], -2)
    qpc = qpc.to(torch.int32)
    deq00 = torch.as_tensor(DEQ4_V[:, 0, 0], device=dc.device)
    deq00 = deq00[(qpc % 6).long()]
    scale = (w00 * deq00)[..., None, None]
    return ((t * scale) << (qpc // 6)[..., None, None]) >> 5


def _blocks_to_mb(blocks, nb, t):
    """[n, nb*nb, t, t] raster blocks -> [n, nb*t, nb*t] MB tiles."""
    n = blocks.shape[0]
    return blocks.reshape(n, nb, nb, t, t).permute(0, 1, 3, 2, 4) \
        .reshape(n, nb * t, nb * t)


def luma_residuals(mb_class, qp, cbp_luma, transform8, luma_ac, luma_dc,
                   luma8, w4_intra, w4_inter, w8_intra, w8_inter):
    """Per-MB luma residual [n,16,16] int32.

    mb_class/qp/cbp_luma/transform8: [n]; luma_ac [n,16,4,4];
    luma_dc [n,4,4]; luma8 [n,4,8,8]; w*: [4,4]/[8,8] weight matrices.
    """
    dev = luma_ac.device
    mb_class = mb_class.to(torch.int32)
    qp = qp.to(torch.int32)
    cbp = cbp_luma.to(torch.int32)
    is_i16 = mb_class == 1
    is_intra = (mb_class == 0) | (mb_class == 1) | (mb_class == 2)
    t8 = (transform8 != 0) & ~is_i16

    w4 = torch.where(is_intra[:, None, None], w4_intra, w4_inter)
    deq = dequant4(luma_ac, qp[:, None], w4[:, None])      # [n,16,4,4]
    dcd = luma_dc_dequant(hadamard4x4(luma_dc), qp, w4_intra[0, 0])
    deq[:, :, 0, 0] = torch.where(is_i16[:, None], dcd.reshape(-1, 16),
                                  deq[:, :, 0, 0])
    res4 = idct4x4(deq)
    blk = torch.arange(16, device=dev)
    b8_of_blk = (blk // 4 // 2) * 2 + (blk % 4) // 2
    coded4 = (((cbp[:, None] >> b8_of_blk[None, :]) & 1) != 0) \
        | is_i16[:, None]
    res4 = torch.where(coded4[:, :, None, None], res4, 0)
    out4 = _blocks_to_mb(res4, 4, 4)

    w8 = torch.where(is_intra[:, None, None], w8_intra, w8_inter)
    res8 = idct8x8(dequant8(luma8, qp[:, None], w8[:, None]))  # [n,4,8,8]
    coded8 = ((cbp[:, None] >> torch.arange(4, device=dev)[None, :]) & 1) != 0
    res8 = torch.where(coded8[:, :, None, None], res8, 0)
    out8 = _blocks_to_mb(res8, 2, 8)
    return torch.where(t8[:, None, None], out8, out4)


def chroma_residuals(mb_class, qp, cbp_chroma, chroma_ac, chroma_dc,
                     chroma_qp_offset, second_chroma_qp_offset,
                     w4_u_intra, w4_v_intra, w4_u_inter, w4_v_inter):
    """Per-MB chroma residuals ([n,8,8] u, [n,8,8] v)."""
    mb_class = mb_class.to(torch.int32)
    cbp = cbp_chroma.to(torch.int32)
    is_intra = (mb_class == 0) | (mb_class == 1) | (mb_class == 2)
    qp = qp.to(torch.int32)
    cqp = torch.as_tensor(CHROMA_QP, device=qp.device)
    has_ac = cbp == 2
    has_dc = cbp != 0
    outs = []
    for c in range(2):
        off = chroma_qp_offset if c == 0 else second_chroma_qp_offset
        qpc = cqp[torch.clamp(qp + off, 0, 51).long()]
        w = torch.where(is_intra[:, None, None],
                        w4_u_intra if c == 0 else w4_v_intra,
                        w4_u_inter if c == 0 else w4_v_inter)
        dcd = chroma_dc_transform_dequant(chroma_dc[:, c], qpc, w[:, 0, 0])
        ac = chroma_ac[:, c * 4:(c + 1) * 4]                  # [n,4,4,4]
        deq = dequant4(ac, qpc[:, None], w[:, None])
        deq = torch.where(has_ac[:, None, None, None], deq, 0)
        deq[:, :, 0, 0] = torch.where(has_dc[:, None], dcd.reshape(-1, 4),
                                      deq[:, :, 0, 0])
        res = idct4x4(deq)
        res = torch.where((has_dc | has_ac)[:, None, None, None], res, 0)
        outs.append(_blocks_to_mb(res, 2, 4))
    return outs[0], outs[1]
