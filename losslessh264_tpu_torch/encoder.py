"""The older fixed-QP encoder: all-intra I16x16 (`IntraEncoder`) and IPPP
with integer-pel full-search ME (`Encoder`), CAVLC through the native
writer.

Port of losslessh264_tpu/encoder.py. As there, the per-MB mode decision,
forward transform, quantisation and reconstruction are host numpy loops:
this module keeps them as a pinned copy (tests/test_torch_encoder_basic.py
holds it to the original), over ref_np's copies of the decoder's inverse
transforms and the port's writer binding (encoder_native). The one device
step of `Encoder._encode_p`, the integer-pel window search of every MB
and the intra cost proxy, runs on the torch device through
ops/me.full_search_sad and intra_sad_proxy. The streams switch the loop
filter off (disable_deblocking_filter_idc = 1) and the search is
integer-pel, so neither kernel (K1, K2) is launched.

`times` accumulates wall milliseconds per part of the encode: "me" (the
device search, its upload and its fetch), "mb_loops" (the host per-MB
loops) and "write" (MV predictors and the native writer).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import encoder_native, ref_np
from .ops import me as tme

# quant multiplier table MF[qp%6][class] (class as in ref_np.POS4)
_MF = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], np.int64)
_ZZ4 = ref_np.ZZ4


def fdct4x4(block):
    """Forward 4x4 core transform. block: [4,4] int."""
    C = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1],
                  [1, -2, 2, -1]], np.int64)
    return C @ block.astype(np.int64) @ C.T


def quant4x4(W, qp, intra=True, skip_dc=False):
    """Quantize transformed block; returns [4,4] levels."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3 if intra else (1 << qbits) // 6
    mf = _MF[qp % 6][ref_np.POS4]
    Z = (np.abs(W) * mf + f) >> qbits
    Z = np.sign(W) * Z
    if skip_dc:
        Z[0, 0] = 0
    return Z.astype(np.int64)


def quant_dc4(Yd, qp):
    """Quantize the Hadamard-transformed I16 luma DC [4,4]."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf = int(_MF[qp % 6][0])
    Z = (np.abs(Yd) * mf + 2 * f) >> (qbits + 1)
    return (np.sign(Yd) * Z).astype(np.int64)


def quant_dc2(Yd, qpc):
    qbits = 15 + qpc // 6
    f = (1 << qbits) // 3
    mf = int(_MF[qpc % 6][0])
    Z = (np.abs(Yd) * mf + 2 * f) >> (qbits + 1)
    return (np.sign(Yd) * Z).astype(np.int64)


def fhadamard4(X):
    H = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                  [1, -1, 1, -1]], np.int64)
    return (H @ X.astype(np.int64) @ H) // 2


def _zz(block4):
    return block4.reshape(16)[_ZZ4]


def _i16_mb(Y, recY, mbi, mb_w, qp, w4, i16_mode, luma_dc, luma_ac):
    """Encode one I16x16 luma MB in place (mode decision + quant + recon)."""
    my, mx = divmod(mbi, mb_w)
    y0, x0 = my * 16, mx * 16
    availL = mx > 0
    availT = my > 0
    src = Y[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
    left = recY[y0:y0 + 16, x0 - 1].astype(np.int32) if availL else None
    top = recY[y0 - 1, x0:x0 + 16].astype(np.int32) if availT else None
    tl = int(recY[y0 - 1, x0 - 1]) if (availL and availT) else 0

    # --- I16 luma mode decision (legal modes only) ---
    cands = []
    if availT:
        cands.append((0, np.tile(top, (16, 1))))
    if availL:
        cands.append((1, np.tile(left[:, None], (1, 16))))
    if availL and availT:
        dc = (int(left.sum()) + int(top.sum()) + 16) >> 5
    elif availL:
        dc = (int(left.sum()) + 8) >> 4
    elif availT:
        dc = (int(top.sum()) + 8) >> 4
    else:
        dc = 128
    cands.append((2, np.full((16, 16), dc, np.int32)))
    if availL and availT:
        cands.append((3, ref_np.plane_pred(left, top, tl, 16, 0)))
    mode, pred = min(cands, key=lambda c: np.abs(src - c[1]).sum())
    i16_mode[mbi] = mode

    # --- transform + quant ---
    resid = src - pred
    Wdc = np.zeros((4, 4), np.int64)
    qac = np.zeros((16, 16), np.int64)
    for b in range(16):
        by, bx = divmod(b, 4)
        W = fdct4x4(resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4])
        Wdc[by, bx] = W[0, 0]
        Z = quant4x4(W, qp, intra=True, skip_dc=True)
        qac[b] = _zz(Z)
    Yd = fhadamard4(Wdc)
    qdc = quant_dc4(Yd, qp)
    luma_dc[mbi] = _zz(qdc)
    luma_ac[mbi] = qac

    # --- reconstruct (exactly as the decoder will) ---
    dct = ref_np.hadamard4x4(qdc)
    dcd = ref_np.luma_dc_dequant(dct, qp, w4)
    rec = np.zeros((16, 16), np.int64)
    for b in range(16):
        by, bx = divmod(b, 4)
        blk = np.zeros(16, np.int64)
        blk[_ZZ4] = qac[b]
        blk = ref_np.dequant4(blk.reshape(4, 4), qp, w4)
        blk[0, 0] = dcd[by, bx]
        rec[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = ref_np.idct4x4(blk)
    recY[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + rec, 0, 255)


def _chroma_intra_mb(U, V, recU, recV, mbi, mb_w, qpc, w4, chroma_dc,
                     chroma_ac):
    """Encode one intra-chroma MB (DC mode), updating recon in place."""
    my, mx = divmod(mbi, mb_w)
    availL = mx > 0
    availT = my > 0
    cy0, cx0 = my * 8, mx * 8
    for ci, (P, R) in enumerate(((U, recU), (V, recV))):
        csrc = P[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32)
        lft = R[cy0:cy0 + 8, cx0 - 1].astype(np.int32) if availL else None
        tp = R[cy0 - 1, cx0:cx0 + 8].astype(np.int32) if availT else None
        predc = np.zeros((8, 8), np.int32)
        for qy in range(2):
            for qx in range(2):
                ls = lft[qy * 4:qy * 4 + 4] if availL else None
                ts = tp[qx * 4:qx * 4 + 4] if availT else None
                if (qy, qx) in ((0, 0), (1, 1)):
                    if availL and availT:
                        d = (int(ls.sum()) + int(ts.sum()) + 4) >> 3
                    elif availT:
                        d = (int(ts.sum()) + 2) >> 2
                    elif availL:
                        d = (int(ls.sum()) + 2) >> 2
                    else:
                        d = 128
                elif (qy, qx) == (0, 1):
                    d = ((int(ts.sum()) + 2) >> 2) if availT else (
                        ((int(ls.sum()) + 2) >> 2) if availL else 128)
                else:
                    d = ((int(ls.sum()) + 2) >> 2) if availL else (
                        ((int(ts.sum()) + 2) >> 2) if availT else 128)
                predc[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = d
        _chroma_block(csrc, predc, R, cy0, cx0, mbi, ci, qpc, w4, chroma_dc,
                      chroma_ac, intra=True)


def _chroma_block(csrc, predc, R, cy0, cx0, mbi, ci, qpc, w4, chroma_dc,
                  chroma_ac, intra):
    """Transform+quant+recon one 8x8 chroma block against `predc`."""
    residc = csrc - predc
    Wd2 = np.zeros((2, 2), np.int64)
    qacs = np.zeros((4, 16), np.int64)
    for b in range(4):
        by, bx = divmod(b, 2)
        W = fdct4x4(residc[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4])
        Wd2[by, bx] = W[0, 0]
        qacs[b] = _zz(quant4x4(W, qpc, intra=intra, skip_dc=True))
    a, b_, c, d_ = (int(Wd2[0, 0]), int(Wd2[0, 1]), int(Wd2[1, 0]),
                    int(Wd2[1, 1]))
    Yd2 = np.array([[a + b_ + c + d_, a - b_ + c - d_],
                    [a + b_ - c - d_, a - b_ - c + d_]], np.int64)
    qd2 = quant_dc2(Yd2, qpc)
    chroma_dc[mbi, ci] = qd2.reshape(4)
    chroma_ac[mbi, ci * 4:(ci + 1) * 4] = qacs
    # recon
    aa, bb, cc, dd = (int(qd2[0, 0]), int(qd2[0, 1]),
                      int(qd2[1, 0]), int(qd2[1, 1]))
    ht = np.array([[aa + bb + cc + dd, aa - bb + cc - dd],
                   [aa + bb - cc - dd, aa - bb - cc + dd]], np.int64)
    dcd2 = ref_np.chroma_dc_dequant(ht, qpc, w4)
    recc = np.zeros((8, 8), np.int64)
    for b in range(4):
        by, bx = divmod(b, 2)
        blk = np.zeros(16, np.int64)
        blk[_ZZ4] = qacs[b]
        blk = ref_np.dequant4(blk.reshape(4, 4), qpc, w4)
        blk[0, 0] = dcd2[by, bx]
        recc[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = ref_np.idct4x4(blk)
    R[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(predc + recc, 0, 255)


def _symbol_planes(n):
    """Zeroed per-MB symbol planes of a frame, in the writer's layout."""
    return dict(i16_mode=np.zeros(n, np.uint8),
                chroma_mode=np.zeros(n, np.uint8),
                i4_modes=np.full((n, 16), 2, np.int8),
                luma_dc=np.zeros((n, 16), np.int16),
                luma_ac=np.zeros((n, 16, 16), np.int16),
                chroma_dc=np.zeros((n, 2, 4), np.int16),
                chroma_ac=np.zeros((n, 8, 16), np.int16))


class _Timed:
    """Accumulates wall milliseconds into times[name] around a block."""

    def __init__(self, times, name):
        self.times, self.name = times, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.times[self.name] += (time.perf_counter() - self.t0) * 1e3


class IntraEncoder:
    """All-intra fixed-QP encoder producing Annex-B .264 (host only: the
    original runs no device code either)."""

    def __init__(self, width, height, qp=28):
        assert width % 16 == 0 and height % 16 == 0, "pad input to MB size"
        self.mb_w = width // 16
        self.mb_h = height // 16
        self.qp = qp
        self.frame_idx = 0
        self._w4 = ref_np.weights4(ref_np.FLAT4)
        self._lib = encoder_native.cfg_lib()
        self.times = {"me": 0.0, "mb_loops": 0.0, "write": 0.0}

    def encode_frame(self, Y, U, V):
        """Encode one frame; returns Annex-B bytes (SPS/PPS on first)."""
        mw, mh, qp = self.mb_w, self.mb_h, self.qp
        n = mw * mh
        qpc = int(ref_np.CHROMA_QP[qp])
        recY = np.zeros((mh * 16, mw * 16), np.uint8)
        recU = np.zeros((mh * 8, mw * 8), np.uint8)
        recV = np.zeros((mh * 8, mw * 8), np.uint8)
        sym = _symbol_planes(n)
        with _Timed(self.times, "mb_loops"):
            for mbi in range(n):
                _i16_mb(Y, recY, mbi, mw, qp, self._w4, sym["i16_mode"],
                        sym["luma_dc"], sym["luma_ac"])
                _chroma_intra_mb(U, V, recU, recV, mbi, mw, qpc, self._w4,
                                 sym["chroma_dc"], sym["chroma_ac"])
        with _Timed(self.times, "write"):
            data = encoder_native.write_frame(
                self._lib, mw, mh, qp, self.frame_idx, slice_type=1,
                mb_class=np.ones(n, np.uint8), mv=np.zeros((n, 2), np.int16),
                include_params=self.frame_idx == 0, **sym)
        self.frame_idx += 1
        self._recon = (recY, recU, recV)
        return data


class Encoder:
    """IPPP fixed-QP encoder: full-search integer-pel ME on the torch
    device (ops/me.full_search_sad), P16x16 / P_Skip / I16 mode decision
    and the per-MB loops on the host, CAVLC through the native writer.
    Streams carry disable_deblocking_filter_idc = 1, so the in-loop recon
    here matches any conformant decoder bit-exactly. device="cuda" (the
    default) raises when no GPU is present; there is no fallback."""

    ME_RADIUS = 16

    def __init__(self, width, height, qp=28, gop=0, device="cuda"):
        assert width % 16 == 0 and height % 16 == 0, "pad input to MB size"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Encoder: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        self.width, self.height = width, height
        self.mb_w = width // 16
        self.mb_h = height // 16
        self.qp = qp
        self.gop = gop  # 0: single IDR then all P
        self.frame_idx = 0
        self.ref = None  # (Y,U,V) recon of the previous frame
        self._w4 = ref_np.weights4(ref_np.FLAT4)
        self._lib = encoder_native.cfg_lib()
        self._intra = IntraEncoder(width, height, qp)
        self.times = self._intra.times
        n = self.mb_w * self.mb_h
        self._ys = torch.as_tensor((np.arange(n) // self.mb_w * 16)
                                   .astype(np.int32), device=self.device)
        self._xs = torch.as_tensor((np.arange(n) % self.mb_w * 16)
                                   .astype(np.int32), device=self.device)

    def encode_frame(self, Y, U, V):
        if self.ref is None or (self.gop and self.frame_idx % self.gop == 0):
            self._intra.frame_idx = self.frame_idx
            data = self._intra.encode_frame(Y, U, V)
            self.ref = self._intra._recon
            self.frame_idx += 1
            return data
        data = self._encode_p(Y, U, V)
        self.frame_idx += 1
        return data

    def _motion_search(self, Y, ref_pad):
        """The device step: per MB the (dx, dy) of its best integer-pel
        match within ME_RADIUS, its SAD and the intra cost proxy, as host
        int32 arrays."""
        mw, mh = self.mb_w, self.mb_h
        dev = self.device
        cur = torch.as_tensor(np.ascontiguousarray(Y), device=dev) \
            .to(torch.int32).reshape(mh, 16, mw, 16).permute(0, 2, 1, 3) \
            .reshape(mw * mh, 16, 16)
        ref_t = torch.as_tensor(ref_pad, device=dev)
        dy, dx, best_sad, _ = tme.full_search_sad(cur, ref_t, self._ys,
                                                  self._xs, self.ME_RADIUS)
        intra_cost = tme.intra_sad_proxy(cur)
        out = torch.stack([dy, dx, best_sad, intra_cost]).cpu().numpy()
        return out[0], out[1], out[2], out[3]

    def _encode_p(self, Y, U, V):
        mw, mh, qp = self.mb_w, self.mb_h, self.qp
        n = mw * mh
        qpc = int(ref_np.CHROMA_QP[qp])
        R = self.ME_RADIUS
        refY, refU, refV = self.ref
        ref_pad8 = np.pad(refY, R, mode="edge")

        with _Timed(self.times, "me"):
            dy, dx, best_sad, intra_cost = self._motion_search(Y, ref_pad8)

        # ---- mode decisions (intra fallback first; final preds after) ----
        with _Timed(self.times, "write"):
            mb_class = np.full(n, 3, np.uint8)  # P16x16
            use_intra = best_sad > intra_cost + 2048
            mb_class[use_intra] = 1
            mv = np.zeros((n, 2), np.int16)
            mv[:, 0] = dx * 4
            mv[:, 1] = dy * 4
            mv[use_intra] = 0
            skip_pred, _ = encoder_native.mv_preds(self._lib, mw, mh, 1,
                                                   mb_class, mv)

        with _Timed(self.times, "mb_loops"):
            ref_pad = ref_pad8.astype(np.int32)
            recY = np.zeros_like(refY)
            recU = np.zeros_like(refU)
            recV = np.zeros_like(refV)
            PADC = R // 2 + 4
            refU_pad = np.pad(refU, PADC, mode="edge")
            refV_pad = np.pad(refV, PADC, mode="edge")
            sym = _symbol_planes(n)
            luma_ac = sym["luma_ac"]
            chroma_dc = sym["chroma_dc"]
            chroma_ac = sym["chroma_ac"]

            for mbi in range(n):
                my, mx = divmod(mbi, mw)
                y0, x0 = my * 16, mx * 16
                if mb_class[mbi] == 1:
                    _i16_mb(Y, recY, mbi, mw, qp, self._w4, sym["i16_mode"],
                            sym["luma_dc"], luma_ac)
                    _chroma_intra_mb(U, V, recU, recV, mbi, mw, qpc,
                                     self._w4, chroma_dc, chroma_ac)
                    continue
                mvx, mvy = int(mv[mbi, 0]), int(mv[mbi, 1])
                # integer-pel luma prediction from padded reference
                py = y0 + (mvy >> 2)
                px = x0 + (mvx >> 2)
                pred = ref_pad[py + R:py + R + 16, px + R:px + R + 16]
                src = Y[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
                resid = src - pred
                qac = np.zeros((16, 16), np.int64)
                rec = np.zeros((16, 16), np.int64)
                for b in range(16):
                    by, bx = divmod(b, 4)
                    W = fdct4x4(resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4])
                    Z = quant4x4(W, qp, intra=False)
                    qac[b] = _zz(Z)
                    blk = np.zeros(16, np.int64)
                    blk[_ZZ4] = qac[b]
                    blk = ref_np.dequant4(blk.reshape(4, 4), qp, self._w4)
                    rec[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                        ref_np.idct4x4(blk)
                # chroma MC prediction (bilinear, decoder-exact)
                cy0, cx0 = y0 // 2, x0 // 2
                predu = ref_np.mc_chroma_block(refU_pad, PADC, cy0, cx0, mvx,
                                               mvy, 8, 8)
                predv = ref_np.mc_chroma_block(refV_pad, PADC, cy0, cx0, mvx,
                                               mvy, 8, 8)
                _chroma_block(U[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32),
                              predu, recU, cy0, cx0, mbi, 0, qpc, self._w4,
                              chroma_dc, chroma_ac, intra=False)
                _chroma_block(V[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int32),
                              predv, recV, cy0, cx0, mbi, 1, qpc, self._w4,
                              chroma_dc, chroma_ac, intra=False)
                luma_ac[mbi] = qac
                recY[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + rec, 0, 255)
                # P_Skip: predictor MV and an all-zero residual
                no_res = (not qac.any() and not chroma_dc[mbi].any()
                          and not chroma_ac[mbi].any())
                if (no_res and mvx == int(skip_pred[mbi, 0])
                        and mvy == int(skip_pred[mbi, 1])):
                    mb_class[mbi] = 11
        with _Timed(self.times, "write"):
            data = encoder_native.write_frame(
                self._lib, mw, mh, qp, self.frame_idx, slice_type=0,
                mb_class=mb_class, mv=mv, include_params=False, **sym)
        self.ref = (recY, recU, recV)
        return data


def encode_yuv(frames, width, height, qp=28, inter=False, gop=0,
               device="cuda"):
    """Encode a list of (Y,U,V) frames; returns Annex-B bytes."""
    enc = (Encoder(width, height, qp, gop=gop, device=device) if inter
           else IntraEncoder(width, height, qp))
    out = b""
    for (Y, U, V) in frames:
        out += enc.encode_frame(Y, U, V)
    return out
