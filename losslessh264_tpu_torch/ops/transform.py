"""Integer transforms and (de)quantization (torch, batched over the frame).

Port of losslessh264_tpu/ops/transform.py: the same integer math on
[..., 4, 4] / [..., 8, 8] blocks, all in int32.

Decode half: dequantization and the inverse transforms (reference
decode_mb_aux.cpp IdctResAddPred_c / IdctResAddPred8x8,
WelsLumaDcDequantIdct, decode_slice.cpp WelsChromaDcIdct). The JAX
package's position-major decode variants exist for the TPU's lane
layout; here the plain block layout is kept, and the tests pin both to
the same results.

Encode half: forward DCT, Hadamards, quantization and zigzag (reference
encode_mb_aux.cpp WelsDctMb / WelsQuant4x4 / WelsHadamardT4Dc), plus the
position-major [16, B] functions the encoder's inter path calls
(`*_pm`, ported as they are written). JAX runs with 64-bit types off, so
its int64 casts in quant4 / quant_dc4 / the forward Hadamards compute
in int32 and wrap; so does every function here (torch's int32 ops wrap
the same way), which keeps the results equal on any input.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ref_np
from .consts import on

DEQ4_V = ref_np.V4[:, ref_np.POS4]      # [6,4,4]
DEQ4_V00 = DEQ4_V[:, 0, 0].copy()       # [6] the DC position's
DEQ8_V = ref_np.V8[:, ref_np.POS8]      # [6,8,8]
CHROMA_QP = ref_np.CHROMA_QP


def _round_shift(c, shift):
    """(c + (1 << max(shift - 1, 0))) >> shift, elementwise int32."""
    one = torch.ones_like(shift)
    return (c + (one << torch.clamp(shift - 1, min=0))) >> shift


def _dequant(coeff, qp, weights, deq, qshift):
    qp = qp.to(torch.int32)
    deq_t = on(deq, coeff.device)
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
    deq00 = on(DEQ4_V00, dc_t.device)[(qp % 6).long()]
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
    deq00 = on(DEQ4_V00, dc.device)[(qpc % 6).long()]
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
    cqp = on(CHROMA_QP, qp.device)
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


# ---------------------------------------------------------------------------
# Forward path (encoder): DCT / Hadamard / quantization. Every product
# stays int32 as JAX computes it (see the module docstring).
# ---------------------------------------------------------------------------
# quant multipliers MF[qp%6] expanded per coefficient position (the
# positional classes of the dequant table POS4)
MF4_V = np.array([[13107, 5243, 8066],
                  [11916, 4660, 7490],
                  [10082, 4194, 6554],
                  [9362, 3647, 5825],
                  [8192, 3355, 5243],
                  [7282, 2893, 4559]], np.int32)[:, ref_np.POS4]  # [6,4,4]
MF4_V00 = MF4_V[:, 0, 0].copy()                     # [6] the DC position's
MF4_PM = MF4_V.reshape(6, 16).T.copy()              # [16, 6] position-major
DEQ4_PM = DEQ4_V.reshape(6, 16).T.copy()            # [16, 6] position-major
ZZ4 = ref_np.ZZ4  # [16] raster index per zigzag position


def _fwd4_last(a):
    """The forward 4-point core transform along the last axis."""
    s0 = a[..., 0] + a[..., 3]
    s1 = a[..., 1] + a[..., 2]
    d0 = a[..., 0] - a[..., 3]
    d1 = a[..., 1] - a[..., 2]
    return torch.stack([s0 + s1, 2 * d0 + d1, s0 - s1, d0 - 2 * d1], dim=-1)


def fdct4x4(blocks):
    """Forward 4x4 core transform. [..,4,4] int -> [..,4,4] int32."""
    b = blocks.to(torch.int32)
    return _fwd4_last(_fwd4_last(b).transpose(-1, -2)).transpose(-1, -2)


def _qparams(qp):
    """(qbits, 1 << qbits) of int32 qp."""
    qbits = 15 + qp // 6
    return qbits, torch.ones_like(qbits) << qbits


def _offset(base, intra):
    """The quantizer's rounding offset: base / 3 for intra blocks, base / 6
    for inter ones; intra a bool or a bool tensor."""
    if isinstance(intra, (bool, np.bool_)):
        return base // 3 if intra else base // 6
    return torch.where(intra, base // 3, base // 6)


def quant4(W, qp, intra, skip_dc=False):
    """Quantize transformed 4x4 blocks. W [..,4,4], qp [..] (broadcast
    against W's leading dims), intra a bool or a [..] bool tensor.
    Returns int32 levels."""
    qp = torch.as_tensor(qp, dtype=torch.int32, device=W.device)
    qbits, base = _qparams(qp)
    f = _offset(base, intra)
    mf = on(MF4_V, W.device)[(qp % 6).long()]
    W = W.to(torch.int32)
    Z = (torch.abs(W) * mf + f[..., None, None]) >> qbits[..., None, None]
    Z = torch.sign(W) * Z
    if skip_dc:
        Z[..., 0, 0] = 0
    return Z


def _fhad4_last(a):
    s0 = a[..., 0] + a[..., 3]
    s1 = a[..., 1] + a[..., 2]
    d0 = a[..., 0] - a[..., 3]
    d1 = a[..., 1] - a[..., 2]
    return torch.stack([s0 + s1, d0 + d1, s0 - s1, d0 - d1], dim=-1)


def fhadamard4x4(X):
    """Forward 4x4 Hadamard of I16 luma DC terms (with a floored //2)."""
    b = X.to(torch.int32)
    return _fhad4_last(_fhad4_last(b).transpose(-1, -2)).transpose(-1, -2) \
        // 2


def quant_dc4(Yd, qp):
    """Quantize Hadamard-transformed DC terms [..,4,4] (or [..,2,2]);
    qp [..]."""
    qp = torch.as_tensor(qp, dtype=torch.int32, device=Yd.device)
    qbits, base = _qparams(qp)
    f = base // 3
    mf = on(MF4_V00, Yd.device)[(qp % 6).long()]
    Yd = Yd.to(torch.int32)
    num = torch.abs(Yd) * mf[..., None, None] + 2 * f[..., None, None]
    Z = num >> (qbits + 1)[..., None, None]
    return torch.sign(Yd) * Z


def fhadamard2x2(X):
    """Forward 2x2 Hadamard of chroma DC terms [..,2,2] (no scaling)."""
    a, b = X[..., 0, 0].to(torch.int32), X[..., 0, 1].to(torch.int32)
    c, d = X[..., 1, 0].to(torch.int32), X[..., 1, 1].to(torch.int32)
    return torch.stack([torch.stack([a + b + c + d, a - b + c - d], -1),
                        torch.stack([a + b - c - d, a - b - c + d], -1)], -2)


def quant_dc2(Yd, qpc):
    """Quantize 2x2 chroma DC [..,2,2]; qpc [..]."""
    return quant_dc4(Yd, qpc)


def zigzag4(blocks):
    """[..,4,4] -> [..,16] in zigzag scan order."""
    flat = blocks.reshape(blocks.shape[:-2] + (16,))
    return flat[..., on(ZZ4, blocks.device)]


# ---------------------------------------------------------------------------
# Position-major functions of the encoder's inter path: [16, B] with the
# block position p = 4*row + col major and the batch of B blocks minor.
# ---------------------------------------------------------------------------
def fdct4x4_pm(x):
    """Position-major forward 4x4 core transform [16, B] -> [16, B]."""
    h = [None] * 16
    for r in range(4):
        a0, a1, a2, a3 = (x[4 * r + c] for c in range(4))
        s0, s1, d0, d1 = a0 + a3, a1 + a2, a0 - a3, a1 - a2
        h[4 * r + 0], h[4 * r + 1] = s0 + s1, 2 * d0 + d1
        h[4 * r + 2], h[4 * r + 3] = s0 - s1, d0 - 2 * d1
    v = [None] * 16
    for c in range(4):
        a0, a1, a2, a3 = (h[4 * r + c] for r in range(4))
        s0, s1, d0, d1 = a0 + a3, a1 + a2, a0 - a3, a1 - a2
        v[0 * 4 + c], v[1 * 4 + c] = s0 + s1, 2 * d0 + d1
        v[2 * 4 + c], v[3 * 4 + c] = s0 - s1, d0 - 2 * d1
    return torch.stack(v)


def quant4_pm(W_pm, qp_b, intra, skip_dc=False, rd_lam=None):
    """Position-major quantization. W_pm [16, B] int32, qp_b [B], intra a
    bool or a [B] bool tensor.

    rd_lam (an int, the dimensionless lambda x256) turns on the
    trellis-lite rounding of the JAX function: a level-1 coefficient is
    zeroed when s = u / 2^qbits, its rounding remainder, falls below
    (rd_lam * DeltaR - 1) / 2 in 1/256 fixed point. `u << 8` overflows
    int32 for qp >= 48 and wraps there, as it does in JAX."""
    dev = W_pm.device
    qp_b = torch.as_tensor(qp_b, dtype=torch.int32, device=dev)
    qbits, base = (a[None, :] for a in _qparams(qp_b))
    f = _offset(base, intra)
    mf = on(MF4_PM, dev)[:, (qp_b % 6).long()]                  # [16, B]
    W_pm = W_pm.to(torch.int32)
    t = torch.abs(W_pm) * mf
    Z = (t + f) >> qbits
    if rd_lam is not None:
        u = t - (Z << qbits)
        s256 = (u << 8) >> qbits
        pos = torch.arange(16, dtype=torch.int32, device=dev)[:, None]
        dr256 = torch.where(Z == 1, 3 * 256 + pos * 48, 0)
        thr256 = (((rd_lam * dr256) >> 8) - 256) // 2
        Z = torch.where((Z >= 1) & (s256 < thr256), Z - 1, Z)
    Z = torch.sign(W_pm) * Z
    if skip_dc:
        Z[0] = 0
    return Z


def dequant4_pm(coeff_pm, qp_b, w_pm):
    """coeff_pm [16, B] int, qp_b [B] int, w_pm [16, B] weights or an
    int (16 = flat)."""
    dev = coeff_pm.device
    qp_b = torch.as_tensor(qp_b, dtype=torch.int32, device=dev)
    ls = w_pm * on(DEQ4_PM, dev)[:, (qp_b % 6).long()]         # [16, B]
    c = coeff_pm.to(torch.int32) * ls
    qdiv = (qp_b // 6)[None, :]
    hi = c << torch.clamp(qdiv - 4, min=0)
    lo = _round_shift(c, torch.clamp(4 - qdiv, min=0))
    return torch.where(qdiv >= 4, hi, lo)


def idct4x4_pm(x):
    """Position-major 4x4 inverse core transform [16, B] -> [16, B],
    incl. the (v+32)>>6."""
    h = [None] * 16
    for r in range(4):
        h[4 * r:4 * r + 4] = _idct4_1d(*(x[4 * r + c] for c in range(4)))
    v = [None] * 16
    for c in range(4):
        v[c::4] = _idct4_1d(*(h[4 * r + c] for r in range(4)))
    return (torch.stack(v) + 32) >> 6
