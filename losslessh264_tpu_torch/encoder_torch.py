"""H.264 encoder with the analysis on PyTorch (one frame at a time).

Port of losslessh264_tpu/encoder_jax.py (`JaxEncoder.encode_frame` and its
frame programs `_i_frame`, `_p_analyze`, `_p_finish`, `_p_intra_fixup`,
`_encode_i_aq`, `_encode_p_aq`). Per P frame, on the device: the dense
integer-pel search per reference (ops/me.py), optionally around a detected
scroll, the partition decision, the half-pel planes of the
width-concatenated reference (the K1 kernel on CUDA), quarter-pel
refinement, the intra-fallback test, chroma MC and the forward transform /
quantization / recon of every MB; intra MBs (all of an IDR, the fallback
MBs of a P frame) go through the slope-2 intra wavefront (plain torch, 16
sequential I4x4 blocks per MB, batched over a diagonal's MBs), and the
reference is deblocked by the K2 kernel on CUDA. The host reads the
frame's symbol planes, decides P_Skip with the native writer's MV
predictors, and writes the slices with the native CAVLC / CABAC writer
(encoder_native.py).

Every option of JaxEncoder is here: rate control (ratectl.py: frame skip,
per-frame QP, the per-row GOM plane), AQ and background detection (the
per-MB QP path), scroll-recentred search, denoise (processing.py), scene
cuts, temporal layers 2-4 (non-reference T1 frames; hierarchical P with
RPLR and MMCO), long-term references, size-capped slices (row plans from
the writer's measured row bits, with one re-encode), several slices, two
references, parameter-set ids (simulcast.py), trellis-lite and cropping.

Left out on purpose (TPU workarounds of JaxEncoder): the scanned
multi-frame P program and its sparse transport (`_p_batch`,
`_dispatch_p_run`; `encode_frames` is a loop over `encode_frame` and
gives the same bytes), the int8 packing of the symbol fetch with its
int16 re-fetch, and the masked lanes of the intra wavefront: a diagonal
step runs only the MBs it encodes, and diagonals without one are skipped.

Byte- and recon-exact vs JaxEncoder on the CPU (tests/test_torch_encoder*.py).
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from . import encoder_native
from . import processing
from . import ratectl
from .decoder_torch import (BLK, PAD, WPAD, _I4_TR_KIND, _edge_pad,
                            _plane_to_tiles, _tiles_to_plane)
from .ops import deblock as tdb
from .ops import intra as tintra
from .ops import mc as tmc
from .ops import me as tme
from .ops import transform as tt
from .ops.consts import on
from .ops.wavefront import diagonals, scatter_tiles
from .ref_np import CHROMA_QP

BIG = 1 << 30
FLAT4 = np.full((4, 4), 16, np.int32)

# SAD-domain Lagrange multiplier per QP (JM-style sqrt(lambda_mode) =
# 0.92 * 2^((qp-12)/6))
LAMBDA = np.asarray(
    [max(1, round(0.92 * 2.0 ** ((q - 12) / 6.0))) for q in range(52)],
    np.int32)

# symbol rows fetched per MB (the column meanings of the JAX package's
# _unpack / _pack_meta, without its transport biases): 427 symbol columns
# luma_dc 16 | luma_ac 256 | chroma_dc 8 | chroma_ac 128 | i16_mode |
# chroma_mode | intra_cls | i4_modes 16; a P frame's rows are META_W meta
# columns (mvx mvy use_intra no_res part mv8[8] ref_idx) and its inter
# luma_ac | chroma_dc | chroma_ac (406 columns)
META_W = 14

# quadrant (8x8) of each 4x4 cell
_CELL_PART8 = ((np.arange(16) // 4) // 2) * 2 + (np.arange(16) % 4) // 2


def _no_stage(name):
    pass


# ---------------------------------------------------------------------------
# tile helpers
# ---------------------------------------------------------------------------
def _blocks16(tile16):
    """[..,16,16] -> [..,16,4,4] raster 4x4 blocks."""
    s = tuple(tile16.shape[:-2])
    return tile16.reshape(s + (4, 4, 4, 4)).transpose(-3, -2) \
        .reshape(s + (16, 4, 4))


def _blocks4(tile8):
    """[..,8,8] -> [..,4,4,4] raster 4x4 blocks."""
    s = tuple(tile8.shape[:-2])
    return tile8.reshape(s + (2, 4, 2, 4)).transpose(-3, -2) \
        .reshape(s + (4, 4, 4))


def _assemble16(blocks):
    """[..,16,4,4] -> [..,16,16]."""
    s = tuple(blocks.shape[:-3])
    return blocks.reshape(s + (4, 4, 4, 4)).transpose(-3, -2) \
        .reshape(s + (16, 16))


def _assemble8(blocks):
    """[..,4,4,4] -> [..,8,8]."""
    s = tuple(blocks.shape[:-3])
    return blocks.reshape(s + (2, 2, 4, 4)).transpose(-3, -2) \
        .reshape(s + (8, 8))


def _windows(plane, y0, x0, h, w):
    """[K, h, w] windows of plane at per-lane top-left (y0, x0)."""
    oy = torch.arange(h, device=plane.device)
    ox = torch.arange(w, device=plane.device)
    return plane[y0[:, None, None] + oy[None, :, None],
                 x0[:, None, None] + ox[None, None, :]]


# ---------------------------------------------------------------------------
# per-MB intra encode, batched over the K MBs of one wavefront step
# ---------------------------------------------------------------------------
def _encode_i16_mb(loc, src, qp, aL, aT):
    """loc [K,17,25] luma recon contexts; src [K,16,16]; qp [K]. Returns
    (mode, qdc_zz [K,16], qac [K,16,4,4], tile [K,16,16], best_sad)."""
    K = loc.shape[0]
    lanes = torch.arange(K, device=loc.device)
    preds = tintra.pred16_all(loc[:, 1:17, 0], loc[:, 0, 1:17], loc[:, 0, 0],
                              aL, aT)                        # [K,4,16,16]
    sads = torch.abs(src[:, None] - preds).sum((2, 3), dtype=torch.int32)
    legal = torch.stack([aT, aL, torch.ones_like(aL), aL & aT], 1)
    sads = torch.where(legal, sads, BIG)
    mode = torch.argmin(sads, 1)
    pred = preds[lanes, mode]

    qp16 = qp[:, None].expand(K, 16)
    W = tt.fdct4x4(_blocks16(src - pred))                    # [K,16,4,4]
    qac = tt.quant4(W, qp16, True, skip_dc=True)
    qdc = tt.quant_dc4(tt.fhadamard4x4(W[:, :, 0, 0].reshape(K, 4, 4)), qp)

    # decoder-exact recon
    dcd = tt.luma_dc_dequant(tt.hadamard4x4(qdc), qp, 16)
    deq = tt.dequant4(qac, qp16, on(FLAT4, loc.device))
    deq[:, :, 0, 0] = dcd.reshape(K, 16)
    tile = torch.clamp(pred + _assemble16(tt.idct4x4(deq)), 0, 255)
    return (mode.to(torch.int32), tt.zigzag4(qdc), qac, tile,
            sads[lanes, mode])


def _encode_i4_mb(loc, src, qp, aL, aT, aTR):
    """I4x4 mode decision + encode: the 16 blocks in coding order, each
    predicting from the previous blocks' reconstruction (8.3.1), over the
    lanes' local buffers. Returns (modes [K,16] raster, qac [K,16,4,4],
    rd_cost [K], tile [K,16,16]).

    The mode-bit cost uses the 8.3.1.1 most-probable-mode rule with
    cross-MB neighbours taken as DC (the RD estimate only; the writer
    computes the true predictor)."""
    K = loc.shape[0]
    dev = loc.device
    lanes = torch.arange(K, device=dev)
    yes = torch.ones(K, dtype=torch.bool, device=dev)
    lam = on(LAMBDA, dev)[qp.long()]
    flat4 = on(FLAT4, dev)
    buf = loc.clone()
    grid = torch.full((K, 5, 5), 2, dtype=torch.int32, device=dev)
    modes = torch.zeros((K, 16), dtype=torch.int32, device=dev)
    qac = torch.zeros((K, 16, 4, 4), dtype=torch.int32, device=dev)
    total = torch.zeros(K, dtype=torch.int32, device=dev)
    mode_idx = torch.arange(9, device=dev)
    keep4 = torch.arange(8, device=dev) < 4
    for d in range(16):
        r = int(BLK[d])
        by, bx = divmod(r, 4)
        ly, lx = 1 + by * 4, 1 + bx * 4
        leftv = buf[:, ly:ly + 4, lx - 1]
        topv = buf[:, ly - 1, lx:lx + 8]
        tl = buf[:, ly - 1, lx - 1]
        kind = int(_I4_TR_KIND[r])
        if kind != 1:
            trv = {0: ~yes, 2: aT, 3: aTR}[kind]
            topv = torch.where(keep4[None, :] | trv[:, None], topv,
                               topv[:, 3:4])
        blk_aL = aL if bx == 0 else yes
        blk_aT = aT if by == 0 else yes
        preds = tintra.pred4_all(leftv, topv, tl, blk_aL, blk_aT)  # [K,9,4,4]
        srcb = src[:, by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
        sads = torch.abs(preds - srcb[:, None]).sum((2, 3), dtype=torch.int32)
        both = blk_aL & blk_aT
        legal = torch.stack([blk_aT, blk_aL, yes, blk_aT, both, both, both,
                             blk_aT, blk_aL], 1)
        pm = torch.where(both, torch.minimum(grid[:, 1 + by, bx],
                                             grid[:, by, 1 + bx]), 2)
        cost = sads + lam[:, None] * torch.where(
            mode_idx[None, :] == pm[:, None], 1, 4)
        cost = torch.where(legal, cost, BIG)
        m = torch.argmin(cost, 1)
        total = total + cost[lanes, m]
        grid[:, 1 + by, 1 + bx] = m.to(torch.int32)
        modes[:, r] = m.to(torch.int32)
        pred = preds[lanes, m]
        q = tt.quant4(tt.fdct4x4(srcb - pred), qp, True)
        rec = tt.idct4x4(tt.dequant4(q, qp, flat4))
        buf[:, ly:ly + 4, lx:lx + 4] = torch.clamp(pred + rec, 0, 255)
        qac[:, r] = q
    return modes, qac, total, buf[:, 1:17, 1:17]


def _encode_luma_mb(loc, src, qp, aL, aT, aTR):
    """I16x16-vs-I4x4 luma decision. Returns (cls 0/1, i16_mode,
    i4_modes [K,16], qdc_zz [K,16], qac [K,16,4,4], tile [K,16,16])."""
    mode16, qdc, qac16, tile16, sad16 = _encode_i16_mb(loc, src, qp, aL, aT)
    modes4, qac4, cost4, tile4 = _encode_i4_mb(loc, src, qp, aL, aT, aTR)
    lam = on(LAMBDA, loc.device)[qp.long()]
    use4 = cost4 < sad16 + lam * 6   # I16 header/mode-bit allowance
    cls = torch.where(use4, 0, 1).to(torch.int32)
    return (cls, mode16, modes4,
            torch.where(use4[:, None], 0, qdc),
            torch.where(use4[:, None, None, None], qac4, qac16),
            torch.where(use4[:, None, None], tile4, tile16))


def _encode_chroma_mb(locu, locv, srcu, srcv, qpc, aL, aT):
    """Intra chroma: one U/V mode decision, then transform/quant/recon.
    Returns (cmode, qdc [K,2,4], qac [K,2,4,16] zigzag, tileU, tileV)."""
    K = locu.shape[0]
    dev = locu.device
    lanes = torch.arange(K, device=dev)
    predsu = tintra.pred_chroma_all(locu[:, 1:9, 0], locu[:, 0, 1:9],
                                    locu[:, 0, 0], aL, aT)
    predsv = tintra.pred_chroma_all(locv[:, 1:9, 0], locv[:, 0, 1:9],
                                    locv[:, 0, 0], aL, aT)
    sads = (torch.abs(srcu[:, None] - predsu).sum((2, 3), dtype=torch.int32)
            + torch.abs(srcv[:, None] - predsv).sum((2, 3),
                                                   dtype=torch.int32))
    legal = torch.stack([torch.ones_like(aL), aL, aT, aL & aT], 1)
    cmode = torch.argmin(torch.where(legal, sads, BIG), 1)
    qpc4 = qpc[:, None].expand(K, 4)
    qdcs, qacs, tiles = [], [], []
    for src, preds in ((srcu, predsu), (srcv, predsv)):
        pred = preds[lanes, cmode]
        W = tt.fdct4x4(_blocks4(src - pred))                 # [K,4,4,4]
        qac = tt.quant4(W, qpc4, True, skip_dc=True)
        qd2 = tt.quant_dc2(tt.fhadamard2x2(W[:, :, 0, 0].reshape(K, 2, 2)),
                           qpc)
        dcd = tt.chroma_dc_transform_dequant(qd2, qpc, 16)
        deq = tt.dequant4(qac, qpc4, on(FLAT4, dev))
        deq[:, :, 0, 0] = dcd.reshape(K, 4)
        rec = _assemble8(tt.idct4x4(deq))
        qdcs.append(qd2.reshape(K, 4))
        qacs.append(tt.zigzag4(qac))
        tiles.append(torch.clamp(pred + rec, 0, 255))
    return (cmode.to(torch.int32), torch.stack(qdcs, 1),
            torch.stack(qacs, 1), tiles[0], tiles[1])


# ---------------------------------------------------------------------------
# intra wavefront over a frame (IDR frames and P intra-fallback MBs)
# ---------------------------------------------------------------------------
def _intra_schedule(mb_w, mb_h, is_intra, row_slice):
    """Host plan of the wavefront: the intra MBs in diagonal order, the
    [start, end) of each diagonal that has any, and per listed MB its
    (index, aL, aT, aTR) as one [k, 4] int64 array."""
    is_intra = np.asarray(is_intra, bool)
    lists = []
    for d in diagonals(mb_w, mb_h):
        d = d[d >= 0]
        d = d[is_intra[d]]
        if len(d):
            lists.append(d.astype(np.int64))
    mb = np.concatenate(lists) if lists else np.zeros(0, np.int64)
    my, mx = mb // mb_w, mb % mb_w
    rs = np.asarray(row_slice)
    aT = (my > 0) & (rs[my] == rs[np.maximum(my - 1, 0)])
    info = np.stack([mb, mx > 0, aT, aT & (mx < mb_w - 1)], 1).astype(
        np.int64)
    ends = np.cumsum([len(v) for v in lists])
    return info, list(zip(np.concatenate([[0], ends[:-1]]), ends))


def intra_wavefront(mb_w, mb_h, srcY, srcU, srcV, inter_y, inter_u, inter_v,
                    is_intra, qp, qpc, row_slice):
    """Encode the intra MBs of a frame as a slope-2 wavefront.

    srcY/U/V: source planes [H,W] / [H/2,W/2]; inter_*: [n,16,16] /
    [n,8,8] reconstructed inter tiles (zeros where intra); is_intra:
    host bool [n]; qp/qpc: per-MB [n] int32 tensors; row_slice: host
    [mb_h] slice index per MB row. One batched step per diagonal that
    holds an intra MB, over those MBs only (JAX computes every lane of
    every diagonal and drops the others' results). Returns per-MB symbol
    planes (i16_mode, intra_cls (1 where not intra), i4_modes (2 where
    not intra), chroma_mode, luma_dc, luma_ac zigzag [n,16,16],
    chroma_dc [n,2,4], chroma_ac [n,2,4,16]) and the recon planes
    (uint8)."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    dev = srcY.device
    i32 = torch.int32
    srcY_t = _plane_to_tiles(srcY.to(i32), mb_w, mb_h, 16)
    srcU_t = _plane_to_tiles(srcU.to(i32), mb_w, mb_h, 8)
    srcV_t = _plane_to_tiles(srcV.to(i32), mb_w, mb_h, 8)
    Yw = F.pad(_tiles_to_plane(inter_y.to(i32), mb_w, mb_h, 16), (WPAD,) * 4)
    Uw = F.pad(_tiles_to_plane(inter_u.to(i32), mb_w, mb_h, 8), (WPAD,) * 4)
    Vw = F.pad(_tiles_to_plane(inter_v.to(i32), mb_w, mb_h, 8), (WPAD,) * 4)

    def z(*shape, fill=0):
        return torch.full(shape, fill, dtype=i32, device=dev)

    i16_mode, intra_cls, chroma_mode = z(n), z(n, fill=1), z(n)
    i4_modes = z(n, 16, fill=2)
    luma_dc, luma_ac = z(n, 16), z(n, 16, 4, 4)
    chroma_dc, chroma_ac = z(n, 2, 4), z(n, 2, 4, 16)

    info, steps = _intra_schedule(mb_w, mb_h, is_intra, row_slice)
    info = torch.as_tensor(info, device=dev)
    for a, b in steps:
        mbs = info[a:b, 0]
        aL, aT, aTR = (info[a:b, k] != 0 for k in (1, 2, 3))
        my, mx = mbs // mb_w, mbs % mb_w
        y0, x0 = my * 16 + WPAD, mx * 16 + WPAD
        cy, cx = my * 8 + WPAD, mx * 8 + WPAD
        cls, mode, m4, qdc, qac, tile = _encode_luma_mb(
            _windows(Yw, y0 - 1, x0 - 1, 17, 25), srcY_t[mbs], qp[mbs],
            aL, aT, aTR)
        cmode, cdc, cac, tu, tv = _encode_chroma_mb(
            _windows(Uw, cy - 1, cx - 1, 9, 9),
            _windows(Vw, cy - 1, cx - 1, 9, 9), srcU_t[mbs], srcV_t[mbs],
            qpc[mbs], aL, aT)
        i16_mode[mbs] = mode
        intra_cls[mbs] = cls
        i4_modes[mbs] = m4
        chroma_mode[mbs] = cmode
        luma_dc[mbs] = qdc
        luma_ac[mbs] = qac
        chroma_dc[mbs] = cdc
        chroma_ac[mbs] = cac
        # every lane of the step encodes (the schedule lists intra MBs
        # only), and its tiles lie inside the planes
        do = torch.ones_like(mbs, dtype=torch.bool)
        Yw = scatter_tiles(Yw, tile, y0, x0, do)
        Uw = scatter_tiles(Uw, tu, cy, cx, do)
        Vw = scatter_tiles(Vw, tv, cy, cx, do)

    u8 = torch.uint8
    return (i16_mode, intra_cls, i4_modes, chroma_mode, luma_dc,
            tt.zigzag4(luma_ac), chroma_dc, chroma_ac,
            Yw[WPAD:WPAD + H, WPAD:WPAD + W].to(u8),
            Uw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2].to(u8),
            Vw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2].to(u8))


# ---------------------------------------------------------------------------
# inter path: ME + refinement + residual of every P MB, batched
# ---------------------------------------------------------------------------
def encode_inter_mbs(mb_w, mb_h, radius, Y, U, V, refY_s, refU_s, refV_s,
                     qp, qpc, scroll_dy=0, rd_lam=None, stage=_no_stage):
    """Whole-frame P-MB analysis.

    refY_s/refU_s/refV_s: [R,H+2P,W+2P] edge-padded reference stacks
    (PAD 32 luma / 16 chroma; R = 1 or 2 short-term references, newest
    first). With R = 2 every MB picks its reference by ME cost, and the
    choice becomes an x offset into width-concatenated reference planes,
    so refinement and MC run once over both. scroll_dy (host int) moves
    the integer search window down by that many rows (a detected global
    scroll); JAX clamps the window's start, torch does not, so its bound
    is checked here: the window and the refinement's reach (radius +
    |scroll_dy| + 4 px) stay inside PAD, as the encoder's clamp keeps
    them. `stage(name)` is called as each stage ends (dense_search,
    subpel_k1, residual). Returns (mvx,
    mvy, use_intra, part, ref_sel, mv8, mvq, luma_ac zigzag, chroma_dc,
    chroma_ac, tile_y, tile_u, tile_v, no_res), as encoder_jax does."""
    n = mb_w * mb_h
    dev = Y.device
    i32 = torch.int32
    R = refY_s.shape[0]
    WpY = refY_s.shape[2]
    WpC = refU_s.shape[2]
    lam = on(LAMBDA, dev)[qp.long()]
    srcY_t = _plane_to_tiles(Y.to(i32), mb_w, mb_h, 16)
    srcU_t = _plane_to_tiles(U.to(i32), mb_w, mb_h, 8)
    srcV_t = _plane_to_tiles(V.to(i32), mb_w, mb_h, 8)
    mbi = torch.arange(n, device=dev)
    mby0 = (mbi // mb_w) * 16
    mbx0 = (mbi % mb_w) * 16

    refcatY = torch.cat(list(refY_s), 1)
    refcatU = torch.cat(list(refU_s), 1)
    refcatV = torch.cat(list(refV_s), 1)

    # integer-pel search per reference at the full radius, every
    # partition shape at once
    Hf, Wf = Y.shape
    sdy = int(scroll_dy)
    if abs(sdy) > PAD - 4 - radius - 1:
        raise ValueError(f"scroll_dy {sdy}: the search window leaves the "
                         f"{PAD}-pixel reference padding")
    o = PAD - radius
    dres = [tme.dense_full_search(Y.to(i32),
                                  refY_s[k, o + sdy:o + sdy + Hf + 2 * radius,
                                         o:o + Wf + 2 * radius], radius)
            for k in range(R)]
    d16, dh, dv, d8 = dres[0]
    ref_sel = torch.zeros(n, dtype=i32, device=dev)
    if R == 2:
        take1 = (dres[1][0][2] + lam) < d16[2]  # te(ref_idx) bit bias

        def _sel(a, b, t):
            return tuple(torch.where(t, y, x) for x, y in zip(a, b))

        d16 = _sel(d16, dres[1][0], take1)
        dh = _sel(dh, dres[1][1], take1.repeat_interleave(2))
        dv = _sel(dv, dres[1][2], take1.repeat_interleave(2))
        d8 = _sel(d8, dres[1][3], take1.repeat_interleave(4))
        ref_sel = take1.to(i32)
    xoffL = ref_sel * WpY
    xoffC = ref_sel * WpC
    stage("dense_search")

    # partition decision on the integer-pel SADs + lambda * side bits
    cost = torch.stack([
        d16[2] + lam * 4,                                # 0: P16x16
        dh[2].reshape(n, 2).sum(1, dtype=i32) + lam * 11,  # 1: P16x8
        dv[2].reshape(n, 2).sum(1, dtype=i32) + lam * 11,  # 2: P8x16
        d8[2].reshape(n, 4).sum(1, dtype=i32) + lam * 20,  # 3: P8x8
    ], 1)
    part = torch.argmin(cost, 1).to(i32)

    # the chosen partition's integer MV per 8x8 quadrant
    quad = torch.arange(4, device=dev)
    pn = part[:, None]

    def _qsel(a16, ah, av, a8):
        a = torch.where(pn == 1, ah.reshape(n, 2)[:, quad // 2],
                        a16[:, None].expand(n, 4))
        a = torch.where(pn == 2, av.reshape(n, 2)[:, quad % 2], a)
        return torch.where(pn == 3, a8.reshape(n, 4), a)

    ivy_q = _qsel(d16[0], dh[0], dv[0], d8[0]).reshape(n * 4) + sdy
    ivx_q = _qsel(d16[1], dh[1], dv[1], d8[1]).reshape(n * 4)

    by8 = (mby0[:, None] + (quad // 2)[None, :] * 8).reshape(-1)   # [4n]
    bx8 = (mbx0[:, None] + (quad % 2)[None, :] * 8).reshape(-1)
    src8 = srcY_t.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n * 4, 8, 8)
    xo4 = xoffL.repeat_interleave(4)

    # K1: half-pel planes of the concatenated reference (uint8, pitched),
    # then the joint quarter-pel refinement of the chosen partition
    planes = tmc._halfpel_planes_u8(refcatY)
    mvqx, mvqy, best_sad, pred_q = tme.subpel_quad(
        planes, PAD, by8, bx8 + xo4, ivx_q * 4, ivy_q * 4, src8, part)
    stage("subpel_k1")

    intra_cost = tme.intra_sad_proxy(srcY_t)
    use_intra = best_sad > intra_cost + 2048
    part = torch.where(use_intra, 0, part)

    def _asm4(blocks, t):
        return blocks.reshape(n, 2, 2, t, t).permute(0, 1, 3, 2, 4) \
            .reshape(n, 2 * t, 2 * t)

    pred_y = _asm4(pred_q, 8)

    # MVs in the writer's partition slots and per 8x8 quadrant
    mvq = torch.stack([mvqx, mvqy], 1).reshape(n, 4, 2)
    mvx = mvq[:, 0, 0]
    mvy = mvq[:, 0, 1]
    p2 = part[:, None, None]
    zpad = torch.zeros((n, 2, 2), dtype=i32, device=dev)
    mv8 = torch.where(p2 == 1, torch.cat([mvq[:, 0::2], zpad], 1),
                      mvq[:, :1].expand(n, 4, 2))
    mv8 = torch.where(p2 == 2, torch.cat([mvq[:, 0:2], zpad], 1), mv8)
    mv8 = torch.where(p2 == 3, mvq, mv8)

    # chroma MC at 4x4 granularity with the selected MV per quadrant
    mv_sel = mvq.reshape(n * 4, 2)
    xoc4 = xoffC.repeat_interleave(4)
    pred_c = [_asm4(tmc.mc_chroma_mbs(ref, PAD // 2, by8 // 2,
                                      bx8 // 2 + xoc4, mv_sel[:, 0],
                                      mv_sel[:, 1], size=4), 4)
              for ref in (refcatU, refcatV)]

    # position-major residual path ([16, B]) as the JAX function has it
    B = n * 16
    r_pm = _blocks16(srcY_t - pred_y).reshape(B, 16).T
    qp_b = qp.to(i32).repeat_interleave(16)
    q_pm = tt.quant4_pm(tt.fdct4x4_pm(r_pm), qp_b, False, rd_lam=rd_lam)
    deq_pm = tt.dequant4_pm(q_pm, qp_b, 16)
    rec = _assemble16(tt.idct4x4_pm(deq_pm).T.reshape(n, 16, 4, 4))
    qac = q_pm.T.reshape(n, 16, 4, 4)
    tile_y = torch.clamp(pred_y + rec, 0, 255)

    cdc = torch.zeros((n, 2, 4), dtype=i32, device=dev)
    cac = torch.zeros((n, 2, 4, 16), dtype=i32, device=dev)
    tiles_c = []
    Bc = n * 4
    qpc_b = qpc.to(i32).repeat_interleave(4)
    for ci, (src_t, pc) in enumerate(((srcU_t, pred_c[0]),
                                      (srcV_t, pred_c[1]))):
        rc_pm = _blocks4(src_t - pc).reshape(Bc, 16).T
        Wc_pm = tt.fdct4x4_pm(rc_pm)
        qc_pm = tt.quant4_pm(Wc_pm, qpc_b, False, skip_dc=True,
                             rd_lam=rd_lam)
        qd2 = tt.quant_dc2(tt.fhadamard2x2(Wc_pm[0].reshape(n, 2, 2)), qpc)
        dcd = tt.chroma_dc_transform_dequant(qd2, qpc, 16)
        deqc_pm = tt.dequant4_pm(qc_pm, qpc_b, 16)
        deqc_pm[0] = dcd.reshape(Bc)
        recc = _assemble8(tt.idct4x4_pm(deqc_pm).T.reshape(n, 4, 4, 4))
        cdc[:, ci] = qd2.reshape(n, 4)
        cac[:, ci] = tt.zigzag4(qc_pm.T.reshape(n, 4, 4, 4))
        tiles_c.append(torch.clamp(pc + recc, 0, 255))

    no_res = ((qac == 0).all(3).all(2).all(1)
              & (cdc == 0).all(2).all(1) & (cac == 0).all(3).all(2).all(1))
    stage("residual")
    return (mvx, mvy, use_intra, part, ref_sel, mv8, mvq, tt.zigzag4(qac),
            cdc, cac, tile_y, tiles_c[0], tiles_c[1], no_res)


# ---------------------------------------------------------------------------
# frame programs
# ---------------------------------------------------------------------------
def _split_src(mb_h, mb_w, buf):
    """Split the uploaded [(H+H/2), W] uint8 buffer into Y, U, V."""
    H, W = mb_h * 16, mb_w * 16
    return buf[:H], buf[H:H + H // 2, :W // 2], buf[H:H + H // 2, W // 2:]


def _pad_refs(recY, recU, recV):
    """Edge-pad [R,H,W] reference stacks (R = number of refs)."""
    return (_edge_pad(recY, PAD), _edge_pad(recU, PAD // 2),
            _edge_pad(recV, PAD // 2))


def _finalize_inter(mb_w, mb_h, tile_y, tile_u, tile_v):
    """Recon planes of a P frame without intra MBs."""
    u8 = torch.uint8
    return (_tiles_to_plane(tile_y.to(u8), mb_w, mb_h, 16),
            _tiles_to_plane(tile_u.to(u8), mb_w, mb_h, 8),
            _tiles_to_plane(tile_v.to(u8), mb_w, mb_h, 8))


def _deblock_recon(mb_w, mb_h, recY, recU, recV, cls, qp, nnz, mv_cells,
                   slice_id, idc, ref_cells=None, stage=_no_stage):
    """The shared in-loop filter (ops/deblock, K2 on CUDA) over the
    encoder's recon planes, with the decoder-layout symbol planes of the
    frame just written and its disable_deblocking_filter_idc, so the
    filtered reference equals what a conformant decoder reconstructs."""
    n = mb_w * mb_h
    dev = recY.device
    i32 = torch.int32
    H, W = mb_h * 16, mb_w * 16
    P = tdb.WPAD
    Yw, Uw, Vw = (F.pad(a.to(i32), (P,) * 4) for a in (recY, recU, recV))
    zeros = torch.zeros(n, dtype=i32, device=dev)
    if ref_cells is None:
        ref_cells = torch.zeros((n, 16), dtype=i32, device=dev)
    params = tdb._edge_params(
        mb_w, mb_h, cls.to(i32), qp.to(i32), nnz.to(i32), mv_cells.to(i32),
        ref_cells.to(i32), slice_id, torch.full((n,), idc, dtype=i32,
                                                device=dev),
        zeros, zeros, zeros, 0)
    stage("deblock_edge_params")
    Yw, Uw, Vw = tdb.deblock_planes(mb_w, mb_h, Yw, Uw, Vw, params)
    stage("deblock_k2")
    u8 = torch.uint8
    return (Yw[P:P + H, P:P + W].to(u8), Uw[P:P + H // 2, P:P + W // 2].to(u8),
            Vw[P:P + H // 2, P:P + W // 2].to(u8))


def _sym_rows(luma_dc, luma_ac, chroma_dc, chroma_ac, i16_mode,
              chroma_mode, intra_cls, i4_modes):
    """[n, 427] int16 symbol rows (the fetch layout)."""
    n = luma_dc.shape[0]
    return torch.cat([luma_dc.reshape(n, 16), luma_ac.reshape(n, 256),
                      chroma_dc.reshape(n, 8), chroma_ac.reshape(n, 128),
                      i16_mode.reshape(n, 1), chroma_mode.reshape(n, 1),
                      intra_cls.reshape(n, 1), i4_modes.reshape(n, 16)],
                     1).to(torch.int16)


def _meta_rows(mvx, mvy, use_intra, no_res, part, mv8, ref_sel):
    """[n, META_W] int16 meta rows of a P frame (column meanings above)."""
    n = mvx.shape[0]
    return torch.cat([torch.stack([mvx, mvy, use_intra.to(torch.int32),
                                   no_res.to(torch.int32), part], 1),
                      mv8.reshape(n, 8), ref_sel[:, None]], 1).to(torch.int16)


def _unpack(rows):
    """Host views (luma_dc, luma_ac [n,16,16], chroma_dc [n,2,4],
    chroma_ac [n,8,16], i16_mode, chroma_mode, intra_cls, i4_modes) of
    fetched [n, 427] symbol rows."""
    return (rows[:, 0:16], rows[:, 16:272].reshape(-1, 16, 16),
            rows[:, 272:280].reshape(-1, 2, 4),
            rows[:, 280:408].reshape(-1, 8, 16), rows[:, 408], rows[:, 409],
            rows[:, 410], rows[:, 411:427])


def _p_analyze(mb_w, mb_h, radius, buf, refY, refU, refV, qp, qpc,
               scroll_dy=0, rd_lam=None, stage=_no_stage):
    """A P frame's analysis: split the source, pad the references, run
    the inter analysis, and gather the [n, 406] int16 rows the host
    fetches, plus the deblock prep planes."""
    n = mb_w * mb_h
    Y, U, V = _split_src(mb_h, mb_w, buf)
    refY_s, refU_s, refV_s = _pad_refs(refY, refU, refV)
    (mvx, mvy, use_intra, part, ref_sel, mv8, mvq, qac_zz, cdc, cac,
     tile_y, tile_u, tile_v, no_res) = encode_inter_mbs(
        mb_w, mb_h, radius, Y, U, V, refY_s, refU_s, refV_s, qp, qpc,
        scroll_dy, rd_lam, stage)
    meta = _meta_rows(mvx, mvy, use_intra, no_res, part, mv8, ref_sel)
    packed = torch.cat([meta, qac_zz.reshape(n, 256).to(torch.int16),
                        cdc.reshape(n, 8).to(torch.int16),
                        cac.reshape(n, 128).to(torch.int16)], 1)
    # deblock prep (the host's later P_Skip / I4 class refinements do not
    # change boundary strengths: skip stays inter with the same MV/nnz,
    # I4 stays intra)
    cls_d = torch.where(use_intra, 1, 3 + part).to(torch.int32)
    nnz_d = (qac_zz != 0).any(-1)
    mvc = mvq[:, on(_CELL_PART8, Y.device), :]  # quadrant MV -> 4x4 cells
    mvc = torch.where(use_intra[:, None, None], 0, mvc)
    refc = ref_sel[:, None].expand(n, 16)
    return (packed, tile_y, tile_u, tile_v, Y, U, V, use_intra, cls_d,
            nnz_d, mvc, refc)


def _p_finish(mb_w, mb_h, idc, tile_y, tile_u, tile_v, cls_d, nnz_d, mvc,
              refc, qp_plane, slice_id, stage=_no_stage):
    """Recon planes of an all-inter P frame + in-loop deblock."""
    recY, recU, recV = _finalize_inter(mb_w, mb_h, tile_y, tile_u, tile_v)
    if idc == 1:
        return recY, recU, recV
    return _deblock_recon(mb_w, mb_h, recY, recU, recV, cls_d, qp_plane,
                          nnz_d, mvc, slice_id, idc, refc, stage)


def _p_intra_fixup(mb_w, mb_h, idc, Y, U, V, tile_y, tile_u, tile_v,
                   use_intra_host, use_intra, cls_d, nnz_d, mvc, refc, qp,
                   qpc, qp_plane, slice_id, row_slice, stage=_no_stage):
    """Some P MBs fell back to intra: the intra wavefront over them, on
    top of the inter recon, then the deblock of the merged recon. Returns
    the intra MBs' [k, 427] symbol rows (MBs in raster order) and the
    recon planes."""
    m = (~use_intra)[:, None, None]
    (i16_mode, intra_cls, i4_modes, chroma_mode, ldc_i, lac_i, cdc_i,
     cac_i, recY, recU, recV) = intra_wavefront(
        mb_w, mb_h, Y, U, V, torch.where(m, tile_y, 0),
        torch.where(m, tile_u, 0), torch.where(m, tile_v, 0),
        use_intra_host, qp, qpc, row_slice)
    idx = torch.as_tensor(np.flatnonzero(use_intra_host), device=Y.device)
    rows = _sym_rows(ldc_i, lac_i, cdc_i, cac_i, i16_mode, chroma_mode,
                     intra_cls, i4_modes)[idx]
    stage("intra")
    if idc != 1:
        cls2 = torch.where(use_intra, intra_cls, cls_d)
        recY, recU, recV = _deblock_recon(mb_w, mb_h, recY, recU, recV, cls2,
                                          qp_plane, nnz_d, mvc, slice_id,
                                          idc, refc, stage)
    return rows, recY, recU, recV


def _i_frame(mb_w, mb_h, idc, buf, qp, qpc, qp_plane, slice_id, row_slice,
             stage=_no_stage):
    """Whole IDR frame: intra wavefront, symbol rows, in-loop deblock."""
    n = mb_w * mb_h
    dev = buf.device
    Y, U, V = _split_src(mb_h, mb_w, buf)
    zt16 = torch.zeros((n, 16, 16), dtype=torch.int32, device=dev)
    zt8 = torch.zeros((n, 8, 8), dtype=torch.int32, device=dev)
    (i16_mode, intra_cls, i4_modes, chroma_mode, ldc, lac, cdc, cac,
     recY, recU, recV) = intra_wavefront(
        mb_w, mb_h, Y, U, V, zt16, zt8, zt8, np.ones(n, bool), qp, qpc,
        row_slice)
    rows = _sym_rows(ldc, lac, cdc, cac, i16_mode, chroma_mode, intra_cls,
                     i4_modes)
    stage("intra")
    if idc != 1:
        recY, recU, recV = _deblock_recon(
            mb_w, mb_h, recY, recU, recV, intra_cls, qp_plane,
            torch.zeros((n, 16), dtype=torch.int32, device=dev),
            torch.zeros((n, 16, 2), dtype=torch.int32, device=dev),
            slice_id, idc, stage=stage)
    return rows, recY, recU, recV


class StageTimer:
    """Wall milliseconds per encoder stage, summed over frames. Each stage
    ends with a torch.cuda.synchronize() on CUDA, so a stage holds its own
    device work; timing is off (and costs nothing) unless an encoder's
    `stages` is set to one of these."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms = {}
        self._t = None

    def _now(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self):
        self._t = self._now()

    def __call__(self, name):
        t = self._now()
        self.ms[name] = self.ms.get(name, 0.0) + (t - self._t) * 1e3
        self._t = t


# ---------------------------------------------------------------------------
# host-side frame driver
# ---------------------------------------------------------------------------
class TorchEncoder:
    """IPPP encoder with the analysis on one torch device; the entropy
    writer is the shared native layer. Takes every option of JaxEncoder
    and refuses the same combinations (ValueError where JaxEncoder
    asserts). device="cuda" (the default) raises when no GPU is present;
    there is no fallback to the CPU.

    Two frame paths, as in JaxEncoder: the fused path (flat QP) and, with
    aq, gom_rc or bgd, the per-MB QP path (`_encode_i_aq` /
    `_encode_p_aq`), which filters the reference after the write with the
    writer's QP chain. `encodes` lists what the last encode_frame call ran,
    one (kind "I"/"P", path "fused"/"aq", is_ref, intra MBs) per encode
    (two when a size-capped slice forced the one re-encode)."""

    ME_RADIUS = 16

    def __init__(self, width, height, qp=28, gop=0, intra_only=False,
                 rc=None, scene_cut=False, aq=False, cabac=False,
                 slices=1, deblock=True, temporal_layers=1,
                 gom_rc=False, ltr=False, refs=1, denoise=False,
                 param_id=0, bgd=False, scroll_me=False,
                 slice_max_bytes=None, trellis=False, device="cuda"):
        if width % 2 or height % 2:
            raise ValueError("4:2:0 needs even dims")
        if slice_max_bytes is not None and slices != 1:
            raise ValueError("slice_max_bytes replaces the fixed slice count")
        if temporal_layers not in (1, 2, 3, 4):
            raise ValueError("1..4 temporal layers")
        if temporal_layers > 2 and (refs != 1 or ltr or aq or gom_rc):
            raise ValueError("hierarchical layers need the plain single-ref "
                             "path")
        if refs not in (1, 2):
            raise ValueError("1 or 2 reference frames")
        if refs == 2 and ltr:
            raise ValueError("refs=2 and LTR are exclusive")
        if refs == 2 and (aq or gom_rc):
            raise ValueError("refs=2 requires the fused (non-AQ) path")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchEncoder: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        # arbitrary (even) sizes: pad to whole MBs and signal the true
        # size by SPS frame cropping (7.4.2.1.1)
        self.width, self.height = width, height
        self.mb_w = -(-width // 16)
        self.mb_h = -(-height // 16)
        self.pad_w = self.mb_w * 16 - width
        self.pad_h = self.mb_h * 16 - height
        self.qp = int(qp)
        self.qpc = int(CHROMA_QP[self.qp])
        self.gop = gop
        self.intra_only = intra_only
        self.rc = rc                 # any ratectl.* controller
        self.scene_cut = scene_cut   # IDR on detected scene changes
        self.aq = aq                 # per-MB adaptive quantization
        self.gom_rc = gom_rc and rc is not None  # per-MB-row RC dqp
        self.bgd = bool(bgd)         # +2 QP on static background MBs
        self.scroll_me = bool(scroll_me)  # search around a detected scroll
        self._scroll_dy = 0
        self.trellis_lam = 144 if trellis else None
        self.cabac = cabac
        self.slices = max(1, min(int(slices), self.mb_h))
        # size-capped slices: row-granular slice plans from the previous
        # frame's measured per-row bits (the writer feeds them back)
        self.slice_max_bytes = (int(slice_max_bytes) if slice_max_bytes
                                else None)
        self._row_bits = None
        self._row_bits_buf = (np.zeros(self.mb_h, np.uint32)
                              if slice_max_bytes else None)
        # in-loop filter: idc 0 filters everything, 2 keeps slices
        # independent (several slices, or size-capped ones), 1 = off
        multi = self.slices > 1 or slice_max_bytes
        self.deblock_idc = (2 if multi else 0) if deblock else 1
        # dyadic temporal scalability: L=2 makes odd frames non-reference
        # T1 frames; L=3/4 is hierarchical P (each frame predicts from its
        # dyadic parent; RPLR brings the parent to L0[0], MMCO 1 drops
        # stale same-or-higher-layer references)
        self.temporal_layers = temporal_layers
        self._gop_pos = 0
        self._dpb = []        # [{pos, fn, layer, recon}] for L >= 3
        self._sps_refs = temporal_layers - 1 if temporal_layers >= 3 else 0
        self._rplr_diff = 0
        self._mmco_drops = None
        # long-term reference: IDRs seed it, mark_ltr() re-marks it,
        # recover_from_ltr() makes the next P frame predict from it
        self.ltr = bool(ltr)
        self._ltr_ref = None
        self._mark_ltr_next = False
        self._use_ltr_next = False
        self.refs = refs
        self.param_id = int(param_id)  # SPS/PPS id (simulcast layers)
        self.denoise = bool(denoise)   # luma flat-region filter first
        self._force_idr = False
        self.ref = None        # (Y, U, V) uint8 recon planes on the device
        self._ref2 = None      # second-newest recon (refs=2)
        self.frame_idx = 0
        self._frame_num = 0    # 7.4.3: advances after each ref frame
        self._idr_id = 0
        self._cur_is_ref = True
        self._prev_src = None  # device luma of the previous source frame
        self._qp_plane = None  # the per-MB QP plane of the per-MB QP path
        self._out_qp = None    # the writer's per-MB QP chain (7.4.5)
        rows_per = -(-self.mb_h // self.slices)
        self._set_row_slice((np.arange(self.mb_h) // rows_per).astype(
            np.int32))
        self._lib = encoder_native.cfg_lib()
        self.stages = None     # a StageTimer to time encode_frame's stages
        self.encodes = []

    # -- helpers ----------------------------------------------------------
    def _stage(self, name):
        if self.stages is not None:
            self.stages(name)

    def _set_row_slice(self, row_slice):
        self._row_slice_np = row_slice
        self._slice_id = torch.as_tensor(
            np.repeat(row_slice, self.mb_w), device=self.device)

    @property
    def _per_mb_qp(self):
        return self.aq or self.gom_rc or self.bgd

    def _write(self, slice_type, mb_class, mv, i16_mode, chroma_mode,
               luma_dc, luma_ac, chroma_dc, chroma_ac, i4_modes, mb_qp=None,
               mv8=None, n_refs=1, ref_plane=None):
        n = self.mb_w * self.mb_h
        # the wavefront emits raster-in-MB modes; MbRecord wants decode
        # order
        i4_modes = np.asarray(i4_modes)[:, np.asarray(BLK)]
        self._out_qp = np.zeros(n, np.uint8)
        dyn = self.slice_max_bytes is not None
        data = encoder_native.write_frame(
            self._lib, self.mb_w, self.mb_h, self.qp, self.frame_idx,
            slice_type=slice_type, mb_class=np.asarray(mb_class, np.uint8),
            mv=np.asarray(mv, np.int16),
            i16_mode=np.asarray(i16_mode, np.uint8),
            chroma_mode=np.asarray(chroma_mode, np.uint8),
            i4_modes=np.ascontiguousarray(i4_modes, np.int8),
            luma_dc=np.asarray(luma_dc, np.int16),
            luma_ac=np.asarray(luma_ac, np.int16),
            chroma_dc=np.asarray(chroma_dc, np.int16),
            chroma_ac=np.asarray(chroma_ac, np.int16),
            include_params=self.frame_idx == 0, mb_qp=mb_qp,
            cabac=self.cabac, n_slices=self.slices, mv8=mv8,
            deblock_idc=self.deblock_idc, out_qp=self._out_qp,
            crop_r=self.pad_w // 2, crop_b=self.pad_h // 2,
            is_ref=self._cur_is_ref, frame_num=self._frame_num,
            idr_id=self._idr_id, ltr_flags=self._ltr_flags(slice_type),
            n_refs=n_refs, ref_plane=ref_plane, sps_refs=self._sps_refs,
            rplr_diff=self._rplr_diff, mmco_drops=self._mmco_drops,
            param_id=self.param_id,
            row_slice=self._row_slice_np if dyn else None,
            out_row_bits=self._row_bits_buf if dyn else None)
        if dyn:
            self._row_bits = self._row_bits_buf.copy()
        self._stage("write")
        return data

    def _plan_dynamic_slices(self):
        """Row -> slice plan of size-capped slices: greedy accumulation of
        the predicted per-row bits (the previous frame's measured costs;
        the first frame takes one row per slice), closing a slice before
        the row that would pass the cap. True when the plan changed."""
        budget = self.slice_max_bytes * 8
        est = self._row_bits
        if est is None:
            est = np.full(self.mb_h, budget, np.float64)
        sl = np.zeros(self.mb_h, np.int32)
        acc, s = 0.0, 0
        for r in range(self.mb_h):
            if r > 0 and acc + float(est[r]) > budget:
                s += 1
                acc = 0.0
            sl[r] = s
            acc += float(est[r])
        changed = not np.array_equal(sl, self._row_slice_np)
        self._set_row_slice(sl)
        return changed

    def _dyn_slice_violated(self):
        """True when a slice of more than one row passed the byte cap."""
        bits = self._row_bits.astype(np.float64)
        sl = self._row_slice_np
        for s in range(sl.max() + 1):
            rows = np.where(sl == s)[0]
            if rows.size > 1 and bits[rows].sum() > self.slice_max_bytes * 8:
                return True
        return False

    def _ltr_flags(self, slice_type):
        if not self.ltr:
            return 0
        flags = 1
        if slice_type == 0 and self._mark_ltr_next and self._cur_is_ref:
            flags |= 2
        if slice_type == 0 and self._use_ltr_next:
            flags |= 4
        return flags

    def mark_ltr(self):
        """Mark the next reference frame as the long-term reference."""
        if not self.ltr:
            raise ValueError("encoder not in LTR mode")
        self._mark_ltr_next = True

    def recover_from_ltr(self):
        """Make the next P frame predict from the long-term reference
        instead of the previous frame (loss recovery without an IDR)."""
        if not self.ltr:
            raise ValueError("encoder not in LTR mode")
        self._use_ltr_next = True

    def _qp_maps(self, Yd=None):
        """Per-MB (qp, qpc) planes on the device: flat QP, or with aq,
        gom_rc or bgd the per-MB plane (AQ offsets, the rate controller's
        per-row dqp, +2 on static background), clipped to 10..51; the
        uint8 plane for the writer is kept in `_qp_plane`."""
        n = self.mb_w * self.mb_h
        if not self._per_mb_qp:
            return (torch.full((n,), self.qp, dtype=torch.int32,
                               device=self.device),
                    torch.full((n,), self.qpc, dtype=torch.int32,
                               device=self.device))
        prev = self._prev_src
        qp_map = np.full(n, self.qp)
        if self.aq:
            dqp, _ = processing.adaptive_quant_map(
                Yd, prev if prev is not None else Yd)
            qp_map = qp_map + dqp.reshape(n)
        if self.gom_rc and prev is not None:
            diff = torch.abs(Yd.to(torch.int32) - prev.to(torch.int32))
            row_cx = diff.reshape(self.mb_h, 16, -1).sum(
                (1, 2), dtype=torch.int32).cpu().numpy()
            qp_map = qp_map + np.repeat(self.rc.gom_dqp(row_cx), self.mb_w)
        if self.bgd and prev is not None:
            bg = processing.background_mask(Yd, prev).cpu().numpy()
            qp_map = qp_map + 2 * bg.reshape(n).astype(np.int32)
        qp_map = np.clip(qp_map, 10, 51)
        self._qp_plane = qp_map.astype(np.uint8)
        self._stage("aq_maps")
        return (torch.as_tensor(qp_map.astype(np.int32), device=self.device),
                torch.as_tensor(CHROMA_QP[qp_map].astype(np.int32),
                                device=self.device))

    def _mv_preds(self, mb_class, mv, mv8=None, ref_plane=None):
        return encoder_native.mv_preds(
            self._lib, self.mb_w, self.mb_h, self.slices, mb_class, mv, mv8,
            ref_plane,
            self._row_slice_np if self.slice_max_bytes else None)

    def _host_buf(self, Y, U, V):
        """Packed host frame: Y on top, U|V side by side below (the
        source edge-padded to whole MBs when the display size is not)."""
        if self.pad_w or self.pad_h:
            Y = np.pad(Y, ((0, self.pad_h), (0, self.pad_w)), mode="edge")
            U = np.pad(U, ((0, self.pad_h // 2), (0, self.pad_w // 2)),
                       mode="edge")
            V = np.pad(V, ((0, self.pad_h // 2), (0, self.pad_w // 2)),
                       mode="edge")
        H, W = self.mb_h * 16, self.mb_w * 16
        buf = np.empty((H + H // 2, W), np.uint8)
        buf[:H] = Y
        buf[H:, :W // 2] = U
        buf[H:, W // 2:] = V
        return buf

    def _upload(self, Y, U, V):
        """The packed frame on the device: one host-to-device copy of
        numpy planes, or built on the device from tensors (the simulcast
        layers' planes), with the same edge padding."""
        if not isinstance(Y, torch.Tensor):
            return torch.from_numpy(self._host_buf(Y, U, V)).to(self.device)
        H, W = self.mb_h * 16, self.mb_w * 16
        dev = self.device

        def edge(p, h, w):
            p = p.to(dev, torch.uint8)
            ys = torch.arange(h, device=dev).clamp(max=p.shape[0] - 1)
            xs = torch.arange(w, device=dev).clamp(max=p.shape[1] - 1)
            return p[ys[:, None], xs[None, :]]

        buf = torch.empty((H + H // 2, W), dtype=torch.uint8, device=dev)
        buf[:H] = edge(Y, H, W)
        buf[H:, :W // 2] = edge(U, H // 2, W // 2)
        buf[H:, W // 2:] = edge(V, H // 2, W // 2)
        return buf

    def _denoise(self, buf):
        """The luma filter of the display-size picture, in place in the
        uploaded buffer, then the MB padding's edge copies again (JAX
        filters before it pads)."""
        h, w = self.height, self.width
        buf[:h, :w] = processing.denoise(buf[:h, :w])
        if self.pad_w:
            buf[:h, w:self.mb_w * 16] = buf[:h, w - 1:w]
        if self.pad_h:
            buf[h:self.mb_h * 16] = buf[h - 1:h]
        self._stage("denoise")

    def _apply_deblock(self, mb_class, luma_ac, mv, mv8=None):
        """Filter self.ref with the frame just written (per-MB QP path):
        the final classes, the writer's QP chain, the luma coefficients'
        nonzero flags and the MVs per 4x4 cell."""
        if self.deblock_idc == 1:
            return
        n = self.mb_w * self.mb_h
        nnz = (np.asarray(luma_ac, np.int16).reshape(n, 16, 16)
               != 0).any(axis=2)
        mv_cells = np.repeat(np.asarray(mv, np.int16)[:, None, :], 16,
                             axis=1)
        if mv8 is not None:
            c = np.arange(16)
            mv8r = np.asarray(mv8, np.int16).reshape(n, 4, 2)
            mbc = np.asarray(mb_class)
            for cls_v, idx in ((4, (c // 4) // 2), (5, (c % 4) // 2),
                               (6, _CELL_PART8)):
                m = mbc == cls_v
                if m.any():
                    mv_cells[m] = mv8r[:, idx][m]
        dev = self.device
        self.ref = _deblock_recon(
            self.mb_w, self.mb_h, *self.ref,
            torch.as_tensor(np.asarray(mb_class, np.int32), device=dev),
            torch.as_tensor(self._out_qp.astype(np.int32), device=dev),
            torch.as_tensor(nnz, device=dev),
            torch.as_tensor(mv_cells.astype(np.int32), device=dev),
            self._slice_id, self.deblock_idc, stage=self._stage)

    # -- frame paths ------------------------------------------------------
    def _encode_i(self, buf):
        n = self.mb_w * self.mb_h
        if self._per_mb_qp:
            return self._encode_i_aq(buf)
        self.encodes.append(("I", "fused", self._cur_is_ref, n))
        qp_d, qpc_d = self._qp_maps()
        rows_d, recY, recU, recV = _i_frame(
            self.mb_w, self.mb_h, self.deblock_idc, buf, qp_d, qpc_d, qp_d,
            self._slice_id, self._row_slice_np, self._stage)
        self.ref = (recY, recU, recV)
        rows = rows_d.cpu().numpy()      # the frame's one symbol fetch
        self._stage("fetch")
        (ldc, lac, cdc, cac, i16m, cm, cls, m4) = _unpack(rows)
        mb_class = np.where(cls == 0, 0, 1).astype(np.uint8)
        mv = np.zeros((n, 2), np.int16)
        # n_refs on an IDR only sizes the SPS DPB (max_num_ref_frames)
        return self._write(1, mb_class, mv, i16m, cm, ldc, lac, cdc, cac,
                           i4_modes=m4, n_refs=self.refs)

    def _encode_p(self, buf):
        if self._per_mb_qp:
            return self._encode_p_aq(buf)
        n = self.mb_w * self.mb_h
        qp_d, qpc_d = self._qp_maps()
        if self.refs == 2 and self._ref2 is not None:
            n_refs = 2
            stack = [torch.stack([a, b]) for a, b in zip(self.ref,
                                                         self._ref2)]
        else:
            n_refs = 1
            stack = [p[None] for p in self.ref]
        (packed_d, tile_y, tile_u, tile_v, Yd, Ud, Vd, use_intra_d, cls_d,
         nnz_d, mvc_d, refc_d) = _p_analyze(
            self.mb_w, self.mb_h, self.ME_RADIUS, buf, *stack, qp_d, qpc_d,
            self._scroll_dy, self.trellis_lam, self._stage)
        packed = packed_d.cpu().numpy()  # the frame's one symbol fetch
        self._stage("fetch")
        meta = packed[:, :META_W]
        use_intra = meta[:, 2] != 0
        no_res = meta[:, 3] != 0
        part = meta[:, 4]
        mv8 = np.ascontiguousarray(meta[:, 5:13], np.int16)
        ref_plane = np.ascontiguousarray(meta[:, 13], np.int8)
        ref_plane[use_intra] = 0
        mv = np.zeros((n, 2), np.int16)
        mv[:, 0] = meta[:, 0]
        mv[:, 1] = meta[:, 1]
        mv[use_intra] = 0
        lac = packed[:, 14:270].reshape(n, 16, 16).copy()
        cdc = packed[:, 270:278].reshape(n, 2, 4).copy()
        cac = packed[:, 278:406].reshape(n, 8, 16).copy()
        ldc = np.zeros((n, 16), np.int16)
        i16m = np.zeros(n, np.int16)
        cm = np.zeros(n, np.int16)
        cls = np.ones(n, np.int16)
        m4 = np.full((n, 16), 2, np.int16)
        self.encodes.append(("P", "fused", self._cur_is_ref,
                             int(use_intra.sum())))
        rec = None
        if use_intra.any():
            rows_d, *rec = _p_intra_fixup(
                self.mb_w, self.mb_h, self.deblock_idc, Yd, Ud, Vd, tile_y,
                tile_u, tile_v, use_intra, use_intra_d, cls_d, nnz_d, mvc_d,
                refc_d, qp_d, qpc_d, qp_d, self._slice_id,
                self._row_slice_np, self._stage)
            # the intra MBs' symbols: a second, small fetch
            idx = np.flatnonzero(use_intra)
            (ldc[idx], lac[idx], cdc[idx], cac[idx], i16m[idx], cm[idx],
             cls[idx], m4[idx]) = _unpack(rows_d.cpu().numpy())
            self._stage("fetch")
        elif self._cur_is_ref:
            # a non-reference frame (T1) never becomes a reference: no
            # recon and no deblock for it
            rec = _p_finish(self.mb_w, self.mb_h, self.deblock_idc, tile_y,
                            tile_u, tile_v, cls_d, nnz_d, mvc_d, refc_d,
                            qp_d, self._slice_id, self._stage)
        if self._cur_is_ref:
            self._ref2 = self.ref if self.refs == 2 else None
            self.ref = tuple(rec)
        # part -> MbClass: 0/1/2/3 = P16x16/P16x8/P8x16/P8x8 (3/4/5/6)
        mb_class = np.where(use_intra, 1, 3 + part).astype(np.uint8)
        skip_pred, _ = self._mv_preds(mb_class, mv, mv8, ref_plane)
        is_skip = (no_res & ~use_intra & (part == 0) & (ref_plane == 0)
                   & (mv[:, 0] == skip_pred[:, 0])
                   & (mv[:, 1] == skip_pred[:, 1]))
        mb_class[is_skip] = 11
        mb_class[use_intra & (cls == 0)] = 0  # I4x4 fallback MBs
        return self._write(0, mb_class, mv, i16m, cm, ldc, lac, cdc, cac,
                           i4_modes=m4, mv8=mv8, n_refs=n_refs,
                           ref_plane=ref_plane)

    def _encode_i_aq(self, buf):
        """IDR on the per-MB QP plane: the intra wavefront, the write with
        mb_qp, then the deblock of the reference."""
        n = self.mb_w * self.mb_h
        self.encodes.append(("I", "aq", self._cur_is_ref, n))
        Yd, Ud, Vd = _split_src(self.mb_h, self.mb_w, buf)
        qp_d, qpc_d = self._qp_maps(Yd)
        zt16 = torch.zeros((n, 16, 16), dtype=torch.int32, device=self.device)
        zt8 = torch.zeros((n, 8, 8), dtype=torch.int32, device=self.device)
        (i16_mode, intra_cls, i4_modes, chroma_mode, ldc, lac, cdc, cac,
         recY, recU, recV) = intra_wavefront(
            self.mb_w, self.mb_h, Yd, Ud, Vd, zt16, zt8, zt8,
            np.ones(n, bool), qp_d, qpc_d, self._row_slice_np)
        self._stage("intra")
        self.ref = (recY, recU, recV)
        rows = _sym_rows(ldc, lac, cdc, cac, i16_mode, chroma_mode,
                         intra_cls, i4_modes).cpu().numpy()
        self._stage("fetch")
        (ldc, lac, cdc, cac, i16m, cm, cls, m4) = _unpack(rows)
        mb_class = np.where(cls == 0, 0, 1).astype(np.uint8)
        mv = np.zeros((n, 2), np.int16)
        data = self._write(1, mb_class, mv, i16m, cm, ldc, lac, cdc, cac,
                           i4_modes=m4, mb_qp=self._qp_plane)
        self._apply_deblock(mb_class, lac, mv)
        return data

    def _encode_p_aq(self, buf):
        """P frame on the per-MB QP plane (one reference): the inter
        analysis, the intra wavefront over its fallback MBs, the write with
        mb_qp, then the deblock of self.ref. Like JaxEncoder, this runs
        the deblock on a non-reference frame too, where self.ref is still
        the previous reference (ROADMAP §3)."""
        n = self.mb_w * self.mb_h
        Yd, Ud, Vd = _split_src(self.mb_h, self.mb_w, buf)
        refY_s, refU_s, refV_s = _pad_refs(*(p[None] for p in self.ref))
        qp_d, qpc_d = self._qp_maps(Yd)
        (mvx, mvy, use_intra_d, part_d, ref_sel_d, mv8_d, mvq_d, qac_zz,
         cdc_d, cac_d, tile_y, tile_u, tile_v, no_res_d) = encode_inter_mbs(
            self.mb_w, self.mb_h, self.ME_RADIUS, Yd, Ud, Vd, refY_s, refU_s,
            refV_s, qp_d, qpc_d, self._scroll_dy, self.trellis_lam,
            self._stage)
        meta = _meta_rows(mvx, mvy, use_intra_d, no_res_d, part_d, mv8_d,
                          ref_sel_d).cpu().numpy()
        use_intra = meta[:, 2] != 0
        no_res = meta[:, 3] != 0
        part = meta[:, 4]
        mv8 = np.ascontiguousarray(meta[:, 5:13], np.int16)
        mv = np.zeros((n, 2), np.int16)
        mv[:, 0] = meta[:, 0]
        mv[:, 1] = meta[:, 1]
        mv[use_intra] = 0
        mb_class = np.where(use_intra, 1, 3 + part).astype(np.uint8)
        self.encodes.append(("P", "aq", self._cur_is_ref,
                             int(use_intra.sum())))
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if use_intra.any():
            m = (~use_intra_d)[:, None, None]
            (i16_mode, intra_cls, i4_modes, chroma_mode, ldc_i, lac_i,
             cdc_i, cac_i, recY, recU, recV) = intra_wavefront(
                self.mb_w, self.mb_h, Yd, Ud, Vd, torch.where(m, tile_y, 0),
                torch.where(m, tile_u, 0), torch.where(m, tile_v, 0),
                use_intra, qp_d, qpc_d, self._row_slice_np)
            self._stage("intra")
            sel = use_intra_d[:, None, None]
            rows_d = _sym_rows(
                torch.where(use_intra_d[:, None], ldc_i, zero),
                torch.where(sel, lac_i, qac_zz), torch.where(sel, cdc_i, cdc_d),
                torch.where(sel[..., None], cac_i, cac_d), i16_mode,
                chroma_mode, intra_cls, i4_modes)
        else:
            recY, recU, recV = _finalize_inter(self.mb_w, self.mb_h, tile_y,
                                               tile_u, tile_v)
            rows_d = _sym_rows(
                torch.zeros((n, 16), dtype=torch.int32, device=self.device),
                qac_zz, cdc_d, cac_d, zero.expand(n), zero.expand(n),
                (zero + 1).expand(n), (zero + 2).expand(n, 16))
        rows = rows_d.cpu().numpy()
        self._stage("fetch")
        (ldc, lac, cdc, cac, i16m, cm, cls, m4) = _unpack(rows)
        # P_Skip: zero residual and the MV equals the skip predictor
        skip_pred, _ = self._mv_preds(mb_class, mv, mv8)
        is_skip = (no_res & ~use_intra & (part == 0)
                   & (mv[:, 0] == skip_pred[:, 0])
                   & (mv[:, 1] == skip_pred[:, 1]))
        mb_class[is_skip] = 11
        mb_class[use_intra & (cls == 0)] = 0  # I4x4 fallback MBs
        if self._cur_is_ref:
            self.ref = (recY, recU, recV)
        data = self._write(0, mb_class, mv, i16m, cm, ldc, lac, cdc, cac,
                           i4_modes=m4, mb_qp=self._qp_plane, mv8=mv8)
        self._apply_deblock(mb_class, lac, mv, mv8)
        return data

    def force_intra_frame(self):
        """Make the next encoded frame an IDR (the reference's
        ISVCEncoder::ForceIntraFrame)."""
        self._force_idr = True

    def load_state(self, ref, ref2=None, frame_idx=0, frame_num=0,
                   idr_id=0, prev_src=None):
        """Continue a stream from another encoder's state: ref / ref2 the
        (Y, U, V) recon planes (uint8, MB-padded) of the newest and the
        second-newest reference, the frame counters, and for scene_cut
        the previous frame's MB-padded source luma."""
        def dev(a):
            return torch.as_tensor(np.array(a, np.uint8),
                                   device=self.device)
        self.ref = tuple(dev(a) for a in ref)
        self._ref2 = None if ref2 is None else tuple(dev(a) for a in ref2)
        self.frame_idx = int(frame_idx)
        self._frame_num = int(frame_num)
        self._idr_id = int(idr_id)
        self._prev_src = None if prev_src is None else dev(prev_src)

    def _layer_setup(self, is_idr):
        """Temporal layer of this frame: whether it is a reference, and
        for hierarchical P its parent as self.ref, RPLR and MMCO."""
        self._cur_is_ref = not (self.temporal_layers == 2 and not is_idr
                                and self.frame_idx % 2 == 1)
        self._rplr_diff, self._mmco_drops = 0, None
        if self.temporal_layers < 3 or is_idr:
            return 0
        # dyadic position: layer from the trailing zeros, parent = the
        # previous frame of the next-lower layer (pos - lowest bit)
        p = self._gop_pos
        L = self.temporal_layers
        layer = L - 1 - min((p & -p).bit_length() - 1, L - 1)
        self._cur_is_ref = layer < L - 1
        parent = next(e for e in self._dpb if e["pos"] == p - (p & -p))
        self.ref = parent["recon"]
        if parent["fn"] != max(e["fn"] for e in self._dpb):
            # the parent is not the default L0[0]: reorder it to the front
            self._rplr_diff = (self._frame_num - parent["fn"]) & 0xff
        if self._cur_is_ref:
            stale = [e for e in self._dpb if e["layer"] >= layer]
            if stale:
                self._mmco_drops = [((self._frame_num - e["fn"]) & 0xff) - 1
                                    for e in stale]
                self._dpb = [e for e in self._dpb if e["layer"] < layer]
        return layer

    def encode_frame(self, Y, U, V, timestamp_ms=None):
        """Encode one frame (uint8 planes of the display size, numpy or
        torch); returns its Annex-B bytes, or b"" when the rate controller
        drops the frame (then no state advances)."""
        if self.stages is not None:
            self.stages.start()
        self.encodes = []
        is_idr = (self.ref is None or self.intra_only or self._force_idr
                  or (self.gop and self.frame_idx % self.gop == 0))
        if self.rc is not None:
            if is_idr:
                self.rc.tick(timestamp_ms)  # IDRs drain the buffer too
            elif self.rc.should_skip(timestamp_ms):
                return b""
        self._force_idr = False
        layer = self._layer_setup(is_idr)
        H = self.mb_h * 16
        buf = self._upload(Y, U, V)
        self._stage("upload")
        cur_src = None
        if (self.scene_cut or self.rc or self.aq or self.bgd
                or self.scroll_me):
            # the analyses read the source before the denoise filter
            cur_src = buf[:H].clone() if self.denoise else buf[:H]
        if self.denoise:
            self._denoise(buf)
        prev = self._prev_src
        scene_idc = ratectl.SCENE_IDC_NONE
        if (self.scene_cut or self.rc is not None) and prev is not None:
            score = float(processing.scene_change_score(cur_src, prev))
            if score > processing.SCENE_CHANGE_RATIO_LARGE:
                scene_idc = ratectl.SCENE_IDC_LARGE
            elif score > processing.SCENE_CHANGE_RATIO_MEDIUM:
                scene_idc = ratectl.SCENE_IDC_MEDIUM
            self._stage("scene_cut")
        if (self.scene_cut and not is_idr
                and scene_idc == ratectl.SCENE_IDC_LARGE):
            is_idr = True
        if self.rc is not None:
            cx = (float(processing.frame_complexity(cur_src, prev))
                  if prev is not None else
                  float(torch.abs(cur_src.to(torch.int32) - 128).sum(
                      dtype=torch.int32)))
            self.qp = int(self.rc.frame_qp(cx, is_idr,
                                           timestamp_ms=timestamp_ms,
                                           scene_idc=scene_idc))
            self.qp = max(10, min(self.qp, 51))
            self.qpc = int(CHROMA_QP[self.qp])
            self._stage("rc")
        self._scroll_dy = 0
        if self.scroll_me and not is_idr and prev is not None:
            det, dy = processing.scroll_detect(cur_src, prev)
            # clamp so the integer MVs stay inside the reference padding
            # that the refinement reads (|mv_int| <= radius + |dy|)
            lim = PAD - 4 - self.ME_RADIUS - 1
            self._scroll_dy = int(np.clip(dy, -lim, lim)) if det else 0
            self._stage("scroll")
        if is_idr:
            self._frame_num = 0
            self._idr_id += 1
            self._ref2 = None  # an IDR empties the DPB
        if self._use_ltr_next and not is_idr:
            # predict from the long-term reference; this frame's recon
            # then re-seeds the short-term chain
            self.ref = self._ltr_ref
        encode = self._encode_i if is_idr else self._encode_p
        if self.slice_max_bytes:
            self._plan_dynamic_slices()
            ref_before, ref2_before = self.ref, self._ref2
            data = encode(buf)
            if self._dyn_slice_violated() and self._plan_dynamic_slices():
                # a slice passed the cap: re-plan from this frame's row
                # costs and encode once more from the same references
                # (both: with refs=2 the first encode rotated _ref2)
                self.ref, self._ref2 = ref_before, ref2_before
                timer, self.stages = self.stages, None
                data = encode(buf)
                self.stages = timer
                self._stage("dyn_slice_reencode")
        else:
            data = encode(buf)
        if self.temporal_layers >= 3:
            if is_idr:
                self._gop_pos = 0
                self._dpb = [{"pos": 0, "fn": self._frame_num, "layer": 0,
                              "recon": self.ref}]
            elif self._cur_is_ref:
                self._dpb.append({"pos": self._gop_pos,
                                  "fn": self._frame_num, "layer": layer,
                                  "recon": self.ref})
            self._gop_pos += 1
        self._use_ltr_next = False
        if self.ltr and self._cur_is_ref and (is_idr or self._mark_ltr_next):
            self._ltr_ref = self.ref  # this frame's recon is the LTR
            self._mark_ltr_next = False
        if self._cur_is_ref:  # 7.4.3: frame_num advances per ref frame
            self._frame_num = (self._frame_num + 1) & 0xff
        if self.rc is not None:
            self.rc.update(8 * len(data))
        self._prev_src = cur_src
        self.frame_idx += 1
        return data

    def encode_frames(self, frames, batch=8):
        """Encode a sequence of (Y, U, V) frames, one encode_frame each.
        `batch` is taken and ignored: JaxEncoder runs `batch` P frames as
        one scanned device program, with bytes equal to per-frame calls
        (encoder_jax.py:1453-1457), which is what this loop gives."""
        return [self.encode_frame(*f) for f in frames]

    @property
    def recon(self):
        """Host copies of the reference planes (MB-padded): the frame just
        encoded when it is a reference, else the reference it predicted
        from (as JaxEncoder's)."""
        return tuple(p.cpu().numpy() for p in self.ref)


def encode_yuv(frames, width, height, qp=28, gop=0, intra_only=False,
               device="cuda"):
    """The Annex-B stream of (Y, U, V) frames, as encoder_jax.encode_yuv."""
    enc = TorchEncoder(width, height, qp=qp, gop=gop, intra_only=intra_only,
                       device=device)
    return b"".join(enc.encode_frames(list(frames)))
