"""H.264 encoder with the analysis on PyTorch (one frame at a time).

Port of losslessh264_tpu/encoder_jax.py (`JaxEncoder.encode_frame` and its
frame programs `_i_frame`, `_p_analyze`, `_p_finish`, `_p_intra_fixup`).
Per P frame, on the device: the dense integer-pel search per reference
(K5, ops/me.py), optionally around a detected scroll, the partition
decision, the half-pel planes of the width-concatenated reference (K1),
quarter-pel refinement, the intra-fallback test, chroma MC and the
residual of every MB (K8); intra MBs (all of an IDR, the fallback MBs of
a P frame) go through the intra wavefront (K4), and the reference is
deblocked (K9 then K2). CPU tensors take each kernel's plain version.

Every frame path runs these steps: an IDR `_i_frame`; a P frame
`_p_analyze`, the fetch of its intra-fallback mask (per frame, inside
its inter MBs' rows), then `_p_intra_fixup` where MBs fell back or else
`_p_finish`, and its symbol rows from `_p_rows`; the host decides P_Skip with the native
writer's MV predictors and writes the slices (`_write_p`, the native
CAVLC / CABAC writer of encoder_native.py). The per-MB QP path (aq,
gom_rc, bgd) runs the steps without their deblock and filters the
reference after the write with the writer's QP chain; `encode_frames`
chains runs of P frames on the device (`_p_batch`) and writes them on a
writer thread (`_drain_p_run`) while the next run's device work goes on.

Every option of JaxEncoder is here: rate control (ratectl.py), AQ and
background detection, scroll-recentred search, denoise (processing.py),
scene cuts, temporal layers 2-4, long-term references, size-capped
slices (with one re-encode), several slices, two references,
parameter-set ids (simulcast.py), trellis-lite and cropping. Left out on
purpose (TPU workarounds of JaxEncoder): the sparse int8 + bitmask
transport of `_p_batch`'s symbols, the int8 packing of the per-frame
symbol fetch with its int16 re-fetch, and the masked lanes of the intra
wavefront (a diagonal step runs only the MBs it encodes).

Byte- and recon-exact vs JaxEncoder on the CPU (tests/test_torch_encoder*.py).
"""
from __future__ import annotations

import ctypes
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from . import encoder_native
from . import processing
from . import ratectl
from . import trace
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
def _mb_avail(mb_w, mb_h, row_slice):
    """[n, 3] host bool (aL, aT, aTR) per MB: aT needs the row above in
    the same slice."""
    mb = np.arange(mb_w * mb_h)
    my, mx = mb // mb_w, mb % mb_w
    rs = np.asarray(row_slice)
    aT = (my > 0) & (rs[my] == rs[np.maximum(my - 1, 0)])
    return np.stack([mx > 0, aT, aT & (mx < mb_w - 1)], 1)


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
    info = np.concatenate([mb[:, None], _mb_avail(mb_w, mb_h, row_slice)[mb]],
                          1).astype(np.int64)
    ends = np.cumsum([len(v) for v in lists])
    return info, list(zip(np.concatenate([[0], ends[:-1]]), ends))


# K4's constant tables, packed in the order csrc/intra_enc.cu reads them:
# the 4x4 decode order, the top-right kinds, the quantizer and
# dequantizer scales [qp % 6, position], LAMBDA, the flat weights, the
# zigzag and the directional 4x4 table
K4_TABLES = np.concatenate([
    BLK, _I4_TR_KIND, tt.MF4_V.reshape(-1), tt.DEQ4_V.reshape(-1), LAMBDA,
    FLAT4.reshape(-1), tt.ZZ4, tintra._TAB4.reshape(-1)]).astype(np.int32)
# K4's per-MB output row, the 427 symbol columns of the fetch layout (the
# comment at META_W, _sym_rows): (name, columns) in order, filled with
# the plain version's values for MBs that are not intra
K4_ROW = (("luma_dc", 16), ("luma_ac", 256), ("chroma_dc", 8),
          ("chroma_ac", 128), ("i16_mode", 1), ("chroma_mode", 1),
          ("intra_cls", 1), ("i4_modes", 16))
K4_ROW_DEFAULT = np.zeros(sum(w for _, w in K4_ROW), np.int32)
K4_ROW_DEFAULT[410] = 1        # intra_cls 1 where not intra
K4_ROW_DEFAULT[411:] = 2       # i4_modes 2 where not intra


def intra_wavefront(mb_w, mb_h, srcY, srcU, srcV, inter_y, inter_u, inter_v,
                    is_intra, qp, qpc, row_slice):
    """Encode the intra MBs of a frame (K4 wrapper).

    srcY/U/V: source planes [H,W] / [H/2,W/2]; inter_*: [n,16,16] /
    [n,8,8] reconstructed inter tiles (zeros where intra); is_intra:
    host bool [n]; qp/qpc: per-MB [n] int32 tensors; row_slice: host
    [mb_h] slice index per MB row. Returns per-MB symbol planes
    (i16_mode, intra_cls (1 where not intra), i4_modes (2 where not
    intra), chroma_mode, luma_dc, luma_ac zigzag [n,16,16], chroma_dc
    [n,2,4], chroma_ac [n,2,4,16]) and the recon planes (uint8). CPU
    tensors take the plain version (intra_wavefront_plain); CUDA tensors
    launch csrc/intra_enc.cu once."""
    if srcY.device.type == "cpu":
        return intra_wavefront_plain(mb_w, mb_h, srcY, srcU, srcV, inter_y,
                                     inter_u, inter_v, is_intra, qp, qpc,
                                     row_slice)
    return _intra_wavefront_launch(mb_w, mb_h, srcY, srcU, srcV, inter_y,
                                   inter_u, inter_v, is_intra, qp, qpc,
                                   row_slice)


intra_wavefront.launches = 0


def _working_planes(mb_w, mb_h, inter_y, inter_u, inter_v):
    """The WPAD-padded int32 working planes holding the inter tiles."""
    i32 = torch.int32
    return tuple(F.pad(_tiles_to_plane(t.to(i32), mb_w, mb_h, s), (WPAD,) * 4)
                 for t, s in ((inter_y, 16), (inter_u, 8), (inter_v, 8)))


def _intra_wavefront_launch(mb_w, mb_h, srcY, srcU, srcV, inter_y, inter_u,
                            inter_v, is_intra, qp, qpc, row_slice):
    """One launch of csrc/intra_enc.cu; CUDA tensors only."""
    ops = k4_operands(mb_w, mb_h, srcY, srcU, srcV, inter_y, inter_u,
                      inter_v, is_intra, qp, qpc, row_slice)
    _build.check(_build.lib().pip_intra_enc(
        *(ctypes.c_void_p(a.data_ptr()) for a in ops), mb_w, mb_h,
        _build.stream(srcY.device)), "intra encode")
    _build.count_launch(intra_wavefront)
    return k4_results(mb_w, mb_h, ops)


def k4_results(mb_w, mb_h, ops):
    """intra_wavefront's results from the operands of a pip_intra_enc
    launch (k4_operands): the symbol columns of the rows (K4_ROW) and the
    uint8 recon cropped from the working planes."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    Yw, Uw, Vw, sym = ops[0], ops[1], ops[2], ops[10]
    cols, o = {}, 0
    for name, w in K4_ROW:
        cols[name] = sym[:, o:o + w]
        o += w
    u8 = torch.uint8
    return (cols["i16_mode"][:, 0], cols["intra_cls"][:, 0],
            cols["i4_modes"], cols["chroma_mode"][:, 0], cols["luma_dc"],
            cols["luma_ac"].reshape(n, 16, 16),
            cols["chroma_dc"].reshape(n, 2, 4),
            cols["chroma_ac"].reshape(n, 2, 4, 16),
            Yw[WPAD:WPAD + H, WPAD:WPAD + W].to(u8),
            Uw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2].to(u8),
            Vw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2].to(u8))


def k4_operands(mb_w, mb_h, srcY, srcU, srcV, inter_y, inter_u, inter_v,
                is_intra, qp, qpc, row_slice):
    """The device operands of pip_intra_enc, checked: the working planes
    (the kernel writes them), int32 sources, the [n, 4] MB rows (is
    intra, aL, aT, aTR; one host-to-device copy), qp, qpc, the tables,
    the [n, 427] symbol rows filled with K4_ROW_DEFAULT, and the sync
    scratch."""
    dev = srcY.device
    if dev.type != "cuda":
        raise ValueError(f"intra encode kernel takes CUDA tensors, got {dev}")
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    i32 = torch.int32
    src = [a.to(i32).contiguous() for a in (srcY, srcU, srcV)]
    want = [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
    if [tuple(a.shape) for a in src] != want:
        raise ValueError(f"source planes {[tuple(a.shape) for a in src]} "
                         f"are not {mb_w}x{mb_h} MBs")
    planes = _working_planes(mb_w, mb_h, inter_y, inter_u, inter_v)
    info = np.concatenate([np.asarray(is_intra, bool).reshape(n, 1),
                           _mb_avail(mb_w, mb_h, row_slice)], 1)
    info = torch.as_tensor(info.astype(np.int32), device=dev)
    qp_t, qpc_t = (a.to(i32).reshape(n).contiguous() for a in (qp, qpc))
    sym = on(K4_ROW_DEFAULT, dev).repeat(n, 1)
    # the row counter and each MB row's progress; the C entry zeroes them
    sync = torch.empty(1 + mb_h, dtype=i32, device=dev)
    return (*planes, *src, info, qp_t, qpc_t, on(K4_TABLES, dev), sym, sync)


def _encode_intra_mbs(mb_w, planes, srcs, qp, qpc, outs, mbs, aL, aT, aTR):
    """Encode the intra MBs `mbs` (int64 tensor; no two of them neighbours,
    as on one wavefront diagonal) as one batched step over the working
    planes `planes` (Yw, Uw, Vw): their symbols go into the [n, ...]
    planes `outs` (i16_mode, intra_cls, i4_modes, chroma_mode, luma_dc,
    luma_ac [n,16,4,4], chroma_dc, chroma_ac) in place. Returns the new
    working planes."""
    Yw, Uw, Vw = planes
    srcY_t, srcU_t, srcV_t = srcs
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
    for out, v in zip(outs, (mode, cls, m4, cmode, qdc, qac, cdc, cac)):
        out[mbs] = v
    # every lane of the step encodes, and its tiles lie inside the planes
    do = torch.ones_like(mbs, dtype=torch.bool)
    return (scatter_tiles(Yw, tile, y0, x0, do),
            scatter_tiles(Uw, tu, cy, cx, do),
            scatter_tiles(Vw, tv, cy, cx, do))


def intra_wavefront_plain(mb_w, mb_h, srcY, srcU, srcV, inter_y, inter_u,
                          inter_v, is_intra, qp, qpc, row_slice):
    """Plain version of K4: the intra MBs of a frame as a slope-2
    wavefront, one batched step per diagonal that holds an intra MB, over
    those MBs only (JAX computes every lane of every diagonal and drops
    the others' results). Arguments and results as intra_wavefront."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    dev = srcY.device
    i32 = torch.int32
    srcs = (_plane_to_tiles(srcY.to(i32), mb_w, mb_h, 16),
            _plane_to_tiles(srcU.to(i32), mb_w, mb_h, 8),
            _plane_to_tiles(srcV.to(i32), mb_w, mb_h, 8))
    planes = _working_planes(mb_w, mb_h, inter_y, inter_u, inter_v)

    def z(*shape, fill=0):
        return torch.full(shape, fill, dtype=i32, device=dev)

    outs = (z(n), z(n, fill=1), z(n, 16, fill=2), z(n), z(n, 16),
            z(n, 16, 4, 4), z(n, 2, 4), z(n, 2, 4, 16))
    info, steps = _intra_schedule(mb_w, mb_h, is_intra, row_slice)
    info = torch.as_tensor(info, device=dev)
    for a, b in steps:
        planes = _encode_intra_mbs(mb_w, planes, srcs, qp, qpc, outs,
                                   info[a:b, 0],
                                   *(info[a:b, k] != 0 for k in (1, 2, 3)))
    Yw, Uw, Vw = planes
    u8 = torch.uint8
    return (*outs[:5], tt.zigzag4(outs[5]), *outs[6:],
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
    with trace.span("enc.search"):
        n = mb_w * mb_h
        dev = Y.device
        i32 = torch.int32
        R = refY_s.shape[0]
        WpY = refY_s.shape[2]
        WpC = refU_s.shape[2]
        lam = on(LAMBDA, dev)[qp.long()]
        srcY_t = _plane_to_tiles(Y.to(i32), mb_w, mb_h, 16)
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
        y_end, x_end = o + sdy + Hf + 2 * radius, o + Wf + 2 * radius
        dres = [tme.dense_full_search(Y.to(i32),
                                      refY_s[k, o + sdy:y_end, o:x_end],
                                      radius)
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

    with trace.span("enc.residual"):
        mvq = torch.stack([mvqx, mvqy], 1).reshape(n, 4, 2)
        (use_intra, part, mv8, qac_zz, cdc, cac, tile_y, tile_u, tile_v,
         no_res) = inter_residual(mb_w, mb_h, Y, U, V, pred_q, mvqx, mvqy,
                                  best_sad, part, refcatU, refcatV, xoffC, qp,
                                  qpc, rd_lam)
        stage("residual")
    return (mvq[:, 0, 0], mvq[:, 0, 1], use_intra, part, ref_sel, mv8, mvq,
            qac_zz, cdc, cac, tile_y, tile_u, tile_v, no_res)


def inter_residual(mb_w, mb_h, Y, U, V, pred_q, mvqx, mvqy, best_sad, part,
                   refcatU, refcatV, xoffC, qp, qpc, rd_lam):
    """K8 wrapper: the residual half of encode_inter_mbs, as
    inter_residual_plain (same arguments and results). CPU tensors take
    the plain version; CUDA tensors one launch of csrc/residual_enc.cu."""
    if Y.device.type == "cpu":
        return inter_residual_plain(mb_w, mb_h, Y, U, V, pred_q, mvqx, mvqy,
                                    best_sad, part, refcatU, refcatV, xoffC,
                                    qp, qpc, rd_lam)
    args, outs, _ = k8_operands(mb_w, mb_h, Y, U, V, pred_q, mvqx, mvqy,
                                best_sad, part, refcatU, refcatV, xoffC, qp,
                                qpc, rd_lam)
    rc = _build.lib().pip_residual_enc(*args, _build.stream(Y.device))
    _build.check(rc, "inter residual")
    _build.count_launch(inter_residual)
    return outs


inter_residual.launches = 0


def k8_operands(mb_w, mb_h, Y, U, V, pred_q, mvqx, mvqy, best_sad, part,
                refcatU, refcatV, xoffC, qp, qpc, rd_lam, host=False):
    """K8's operands on CUDA tensors, checked: the source planes (uint8 or
    int32, unit column stride, U and V with one row stride), the int32
    per-quadrant and per-MB vectors, the uint8 concatenated chroma
    references (contiguous, one shape, a width of a multiple of 4), rd_lam
    (None: -1) and the fresh outputs. The kernel stages the source rows
    in chunks of 4 bytes or more, pred_q and the MVs in 16, and reads the
    references by aligned words: a plane whose start or row stride is not
    a multiple of 4 bytes, or a pred_q, MV vector or reference that does
    not start on 16 bytes, is copied first. Returns (the args of
    pip_residual_enc before the stream, the outputs in inter_residual's
    order, the tensors the args point into). host=True takes CPU tensors,
    for the kernel's CPU emulation (tools/cuda_emu.py)."""
    dev = Y.device
    if dev.type != "cuda" and not host:
        raise ValueError(f"inter residual kernel takes CUDA tensors, got "
                         f"{dev}")
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    i32 = torch.int32
    P = ctypes.c_void_p
    srcs = [Y, U, V]
    if any(a.device != dev or a.dtype != Y.dtype for a in srcs) or \
            Y.dtype not in (torch.uint8, i32) or \
            [tuple(a.shape) for a in srcs] != [(H, W), (H // 2, W // 2),
                                               (H // 2, W // 2)]:
        raise ValueError(f"inter residual kernel: source planes "
                         f"{[(tuple(a.shape), a.dtype) for a in srcs]}, "
                         f"the kernel takes uint8 or int32 planes of "
                         f"{mb_w}x{mb_h} MBs on {dev}")
    def unfit(a):
        return (a.stride(1) != 1 or a.stride(0) * a.element_size() % 4
                or a.data_ptr() % 4)

    if unfit(Y):
        srcs[0] = Y.clone(memory_format=torch.contiguous_format)
    if unfit(U) or unfit(V) or U.stride(0) != V.stride(0):
        srcs[1:] = [a.clone(memory_format=torch.contiguous_format)
                    for a in (U, V)]
    vecs = []
    for a, shape in ((pred_q, (4 * n, 8, 8)), (mvqx, (4 * n,)),
                     (mvqy, (4 * n,)), (best_sad, (n,)), (part, (n,)),
                     (xoffC, (n,)), (qp, (n,)), (qpc, (n,))):
        if a.device != dev or tuple(a.shape) != shape:
            raise ValueError(f"inter residual kernel: an operand "
                             f"{tuple(a.shape)} on {a.device}, the kernel "
                             f"takes {shape} on {dev}")
        vecs.append(a.to(i32).contiguous())
    vecs[:3] = [a.clone() if a.data_ptr() % 16 else a for a in vecs[:3]]
    refs = [refcatU, refcatV]
    if any(r.device != dev or r.dtype != torch.uint8 or r.dim() != 2
           or not r.is_contiguous() or r.shape != refcatU.shape
           for r in refs) or refcatU.shape[0] != H // 2 + PAD or \
            refcatU.shape[1] % 4:
        raise ValueError("inter residual kernel takes contiguous uint8 "
                         f"[{H // 2 + PAD}, Wc] chroma references, Wc a "
                         "multiple of 4")
    refs = [r.clone() if r.data_ptr() % 16 else r for r in refs]
    if rd_lam is not None and not 0 <= int(rd_lam) < 2 ** 31:
        raise ValueError(f"inter residual kernel: rd_lam {rd_lam}")
    outs = (torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=i32, device=dev),
            torch.empty((n, 4, 2), dtype=i32, device=dev),
            torch.empty((n, 16, 16), dtype=i32, device=dev),
            torch.empty((n, 2, 4), dtype=i32, device=dev),
            torch.empty((n, 2, 4, 16), dtype=i32, device=dev),
            torch.empty((n, 16, 16), dtype=i32, device=dev),
            torch.empty((n, 8, 8), dtype=i32, device=dev),
            torch.empty((n, 8, 8), dtype=i32, device=dev),
            torch.empty(n, dtype=torch.bool, device=dev))
    args = ([P(a.data_ptr()) for a in srcs]
            + [srcs[0].element_size(), srcs[0].stride(0), srcs[1].stride(0)]
            + [P(a.data_ptr()) for a in vecs + refs]
            + [refcatU.shape[0], refcatU.shape[1],
               -1 if rd_lam is None else int(rd_lam)]
            + [P(o.data_ptr()) for o in (outs[0], outs[9]) + outs[1:9]]
            + [mb_w, mb_h])
    return args, outs, srcs + vecs + refs


def inter_residual_plain(mb_w, mb_h, Y, U, V, pred_q, mvqx, mvqy, best_sad,
                         part, refcatU, refcatV, xoffC, qp, qpc, rd_lam):
    """Plain version of K8: the residual half of encode_inter_mbs after
    the subpel refinement. Y/U/V: the source planes; pred_q [4n, 8, 8]
    int32 and mvqx/mvqy [4n] the refined quadrants' luma prediction and
    quarter-pel MVs, best_sad [n] their SAD; part [n] the partition;
    refcatU/refcatV the width-concatenated edge-padded chroma references
    and xoffC [n] each MB's x offset into them; qp, qpc [n]; rd_lam None
    or the trellis-lite lambda. The intra SAD proxy and the intra
    fallback, the writer's partition MVs, chroma MC, and the
    position-major residual path as the JAX function has it. Returns
    (use_intra, part, mv8, luma levels in zigzag order, chroma_dc,
    chroma_ac, tile_y, tile_u, tile_v, no_res)."""
    n = mb_w * mb_h
    dev = Y.device
    i32 = torch.int32
    srcY_t = _plane_to_tiles(Y.to(i32), mb_w, mb_h, 16)
    srcU_t = _plane_to_tiles(U.to(i32), mb_w, mb_h, 8)
    srcV_t = _plane_to_tiles(V.to(i32), mb_w, mb_h, 8)
    mbi = torch.arange(n, device=dev)
    quad = torch.arange(4, device=dev)
    by8 = ((mbi // mb_w) * 16)[:, None] + (quad // 2)[None, :] * 8
    bx8 = ((mbi % mb_w) * 16)[:, None] + (quad % 2)[None, :] * 8
    by8, bx8 = by8.reshape(-1), bx8.reshape(-1)

    intra_cost = tme.intra_sad_proxy(srcY_t)
    use_intra = best_sad > intra_cost + 2048
    part = torch.where(use_intra, 0, part)

    def _asm4(blocks, t):
        return blocks.reshape(n, 2, 2, t, t).permute(0, 1, 3, 2, 4) \
            .reshape(n, 2 * t, 2 * t)

    pred_y = _asm4(pred_q, 8)

    # MVs in the writer's partition slots and per 8x8 quadrant
    mvq = torch.stack([mvqx, mvqy], 1).reshape(n, 4, 2)
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
    return (use_intra, part, mv8, tt.zigzag4(qac), cdc, cac, tile_y,
            tiles_c[0], tiles_c[1], no_res)


# ---------------------------------------------------------------------------
# frame programs
# ---------------------------------------------------------------------------
def _split_src(mb_h, mb_w, buf):
    """Split the uploaded [(H+H/2), W] uint8 buffer into Y, U, V."""
    H, W = mb_h * 16, mb_w * 16
    return buf[:H], buf[H:H + H // 2, :W // 2], buf[H:H + H // 2, W // 2:]


def _deblock_recon(mb_w, mb_h, recY, recU, recV, cls, qp, nnz, mv_cells,
                   slice_id, idc, ref_cells=None, stage=_no_stage):
    """The shared in-loop filter (ops/deblock: K9 then K2 on CUDA) over
    the encoder's recon planes, with the decoder-layout symbol planes of
    the frame just written and its disable_deblocking_filter_idc, so the
    filtered reference equals what a conformant decoder reconstructs.
    The planes go in as they are (K9 reads each dtype; no ref_cells,
    alpha_off, beta_off or transform8 plane reads as 0). The working
    planes are three views of one zeroed int32 buffer, which K2 filters
    in place."""
    H, W = mb_h * 16, mb_w * 16
    P = tdb.WPAD
    shapes = ((H + 2 * P, W + 2 * P), (H // 2 + 2 * P, W // 2 + 2 * P),
              (H // 2 + 2 * P, W // 2 + 2 * P))
    sizes = [h * w for h, w in shapes]
    buf = torch.zeros(sum(sizes), dtype=torch.int32, device=recY.device)
    work = [b.view(sh) for b, sh in zip(buf.split(sizes), shapes)]
    for w, a in zip(work, (recY, recU, recV)):
        w[P:-P, P:-P] = a
    params = tdb.edge_params(mb_w, mb_h, cls, qp, nnz, mv_cells, ref_cells,
                             slice_id, idc, None, None, None, 0)
    stage("deblock_edge_params")
    Yw, Uw, Vw = tdb.deblock_planes(mb_w, mb_h, *work, params, inplace=True)
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
    """Host views of fetched rows: (meta, intra_cls, planes). planes: the
    writer's symbol planes by its keywords (luma_dc, luma_ac [n,16,16],
    chroma_dc [n,2,4], chroma_ac [n,8,16], i16_mode, chroma_mode,
    i4_modes); meta: None for [n, 427] symbol rows, and for a P frame's
    [n, META_W + 427] rows its meta columns by name (mv [n,2], use_intra,
    no_res, part, mv8 [n,8], ref_idx). Views only: nothing is read."""
    m = rows.shape[1] - 427
    meta = None if m == 0 else {
        "mv": rows[:, 0:2], "use_intra": rows[:, 2], "no_res": rows[:, 3],
        "part": rows[:, 4], "mv8": rows[:, 5:13], "ref_idx": rows[:, 13]}
    planes = {"luma_dc": rows[:, m:m + 16],
              "luma_ac": rows[:, m + 16:m + 272].reshape(-1, 16, 16),
              "chroma_dc": rows[:, m + 272:m + 280].reshape(-1, 2, 4),
              "chroma_ac": rows[:, m + 280:m + 408].reshape(-1, 8, 16),
              "i16_mode": rows[:, m + 408], "chroma_mode": rows[:, m + 409],
              "i4_modes": rows[:, m + 411:m + 427]}
    return meta, rows[:, m + 410], planes


def _p_rows(packed, use_intra=None, intra_rows=None):
    """A P frame's [n, META_W + 427] int16 rows on the device (meta ++
    symbol columns, the fetch layout), from _p_analyze's packed rows: the
    inter MBs' levels with an inter MB's constant intra columns, and where
    MBs fell back to intra (use_intra, the device mask) their rows of
    _p_intra_fixup's (intra_rows)."""
    n = packed.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=packed.device)
    syms = _sym_rows(zero.expand(n, 16), packed[:, META_W:META_W + 256],
                     packed[:, META_W + 256:META_W + 264],
                     packed[:, META_W + 264:META_W + 392], zero.expand(n),
                     zero.expand(n), (zero + 1).expand(n),
                     (zero + 2).expand(n, 16))
    if intra_rows is not None:
        syms = torch.where(use_intra[:, None], intra_rows, syms)
    return torch.cat([packed[:, :META_W], syms], 1)


def _p_analyze(mb_w, mb_h, radius, buf, refY, refU, refV, qp, qpc,
               scroll_dy=0, rd_lam=None, stage=_no_stage):
    """A P frame's analysis: split the source, pad the references, run
    the inter analysis, and gather the [n, 406] int16 rows the host
    fetches, plus the deblock prep planes."""
    n = mb_w * mb_h
    Y, U, V = _split_src(mb_h, mb_w, buf)
    with trace.span("enc.pad_refs"):
        refY_s, refU_s, refV_s = (_edge_pad(refY, PAD),
                                  _edge_pad(refU, PAD // 2),
                                  _edge_pad(refV, PAD // 2))
    (mvx, mvy, use_intra, part, ref_sel, mv8, mvq, qac_zz, cdc, cac,
     tile_y, tile_u, tile_v, no_res) = encode_inter_mbs(
        mb_w, mb_h, radius, Y, U, V, refY_s, refU_s, refV_s, qp, qpc,
        scroll_dy, rd_lam, stage)
    with trace.span("enc.pack"):
        meta = _meta_rows(mvx, mvy, use_intra, no_res, part, mv8, ref_sel)
        packed = torch.cat([meta, qac_zz.reshape(n, 256).to(torch.int16),
                            cdc.reshape(n, 8).to(torch.int16),
                            cac.reshape(n, 128).to(torch.int16)], 1)
        # deblock prep (the host's later P_Skip / I4 class refinements do
        # not change boundary strengths: skip stays inter with the same
        # MV/nnz, I4 stays intra)
        cls_d = torch.where(use_intra, 1, 3 + part).to(torch.int32)
        nnz_d = (qac_zz != 0).any(-1)
        mvc = mvq[:, on(_CELL_PART8, Y.device), :]  # quadrant MV -> cells
        mvc = torch.where(use_intra[:, None, None], 0, mvc)
        refc = ref_sel[:, None].expand(n, 16)
    return (packed, tile_y, tile_u, tile_v, Y, U, V, use_intra, cls_d,
            nnz_d, mvc, refc)


def _p_finish(mb_w, mb_h, idc, tile_y, tile_u, tile_v, cls_d, nnz_d, mvc,
              refc, qp_plane, slice_id, stage=_no_stage):
    """Recon planes of an all-inter P frame + in-loop deblock."""
    recY, recU, recV = (_tiles_to_plane(t.to(torch.uint8), mb_w, mb_h, s)
                        for t, s in ((tile_y, 16), (tile_u, 8), (tile_v, 8)))
    if idc == 1:
        return recY, recU, recV
    return _deblock_recon(mb_w, mb_h, recY, recU, recV, cls_d, qp_plane,
                          nnz_d, mvc, slice_id, idc, refc, stage)


def _p_intra_fixup(mb_w, mb_h, idc, Y, U, V, tile_y, tile_u, tile_v,
                   use_intra_host, use_intra, cls_d, nnz_d, mvc, refc, qp,
                   qpc, qp_plane, slice_id, row_slice, stage=_no_stage):
    """Some P MBs fell back to intra: the intra wavefront over them, on
    top of the inter recon, then the deblock of the merged recon. Returns
    the wavefront's [n, 427] symbol rows (the intra MBs' symbols, an
    inter MB's constants elsewhere) and the recon planes."""
    m = (~use_intra)[:, None, None]
    (i16_mode, intra_cls, i4_modes, chroma_mode, ldc_i, lac_i, cdc_i,
     cac_i, recY, recU, recV) = intra_wavefront(
        mb_w, mb_h, Y, U, V, torch.where(m, tile_y, 0),
        torch.where(m, tile_u, 0), torch.where(m, tile_v, 0),
        use_intra_host, qp, qpc, row_slice)
    rows = _sym_rows(ldc_i, lac_i, cdc_i, cac_i, i16_mode, chroma_mode,
                     intra_cls, i4_modes)
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


def _fetch(t):
    """A host numpy copy of t (a synchronizing fetch)."""
    host = t.cpu().numpy()
    trace.count_bytes("enc.d2h_bytes", host)
    return host


def _to_host(t):
    """(a host copy of t, None) on the CPU; on CUDA (a pinned host tensor
    that a non-blocking copy fills, the CUDA event that marks the copy
    done), so the device's stream runs on while the copy is in flight."""
    trace.count_bytes("enc.d2h_bytes", t)
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _p_batch(mb_w, mb_h, radius, idc, bufs, refY, refU, refV, qp, qpc,
             slice_id, row_slice, rd_lam=None):
    """K consecutive P frames chained on the device, each predicting from
    the recon of the one before (JaxEncoder._p_batch, whose lax.scan is a
    loop here). Per frame: the analysis (_p_analyze, K1 inside), one
    small fetch of the intra-fallback mask, the intra fixup where an MB
    falls back (_p_intra_fixup) or else _p_finish, each with the deblock
    (K2) unless idc == 1, and the frame's [n, META_W + 427] int16 rows
    (meta ++ symbol columns) on their way to the host (_to_host). JAX
    decides the fixup on the device with lax.cond; the port's fixup
    schedules its MBs from a host mask, hence the fetch.

    bufs: [K, H + H/2, W] uint8 source frames (_upload layout); refY,
    refU, refV: the unpadded recon planes of the frame before. Returns
    ([(rows, ready, intra MBs)] per frame, the last frame's recon)."""
    rec = (refY, refU, refV)
    out = []
    for buf in bufs:
        (packed, tile_y, tile_u, tile_v, Yd, Ud, Vd, use_intra_d, cls_d,
         nnz_d, mvc, refc) = _p_analyze(mb_w, mb_h, radius, buf,
                                        *(p[None] for p in rec), qp, qpc,
                                        rd_lam=rd_lam)
        with trace.span("enc.mask_fetch"):
            use_intra = _fetch(use_intra_d)
        intra_rows = None
        if use_intra.any():
            with trace.span("enc.intra_fixup"):
                intra_rows, *rec = _p_intra_fixup(
                    mb_w, mb_h, idc, Yd, Ud, Vd, tile_y, tile_u, tile_v,
                    use_intra, use_intra_d, cls_d, nnz_d, mvc, refc, qp, qpc,
                    qp, slice_id, row_slice)
        else:
            with trace.span("enc.finish"):
                rec = _p_finish(mb_w, mb_h, idc, tile_y, tile_u, tile_v,
                                cls_d, nnz_d, mvc, refc, qp, slice_id)
        with trace.span("enc.pack"):
            rows = _p_rows(packed, use_intra_d, intra_rows)
        with trace.span("enc.to_host"):
            out.append((*_to_host(rows), int(use_intra.sum())))
    return out, tuple(rec)


StageTimer = trace.StageTimer   # the tracer's marker mode


# ---------------------------------------------------------------------------
# host-side frame driver
# ---------------------------------------------------------------------------
class TorchEncoder:
    """IPPP encoder with the analysis on one torch device; the entropy
    writer is the shared native layer. Takes every option of JaxEncoder
    and refuses the same combinations (ValueError where JaxEncoder
    asserts). device="cuda" (the default) raises when no GPU is present;
    there is no fallback to the CPU.

    The frame paths (the module's docstring): the fused path (flat QP),
    the per-MB QP path with aq, gom_rc or bgd, and encode_frames' runs.
    `encodes` lists what the last encode_frame call ran, one (kind
    "I"/"P", path "fused"/"aq", is_ref, intra MBs) per encode (two when a
    size-capped slice forced the one re-encode).
    """

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
        self._qp_plane = None  # the per-MB QP path's QP plane (None: fused)
        self._out_qp = None    # the writer's per-MB QP chain (7.4.5)
        rows_per = -(-self.mb_h // self.slices)
        self._set_row_slice((np.arange(self.mb_h) // rows_per).astype(
            np.int32))
        self._lib = encoder_native.cfg_lib()
        self.stages = None     # a StageTimer to time encode_frame's stages
        self.encodes = []
        # encode_frames' runs: ms of entropy writing on the writer thread,
        # ms the caller waited for it, and the frames it wrote
        self.prof = {"entropy_ms": 0.0, "writer_wait_ms": 0.0, "frames": 0}

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
            host = self._host_buf(Y, U, V)
            trace.count_bytes("enc.h2d_bytes", host)
            return torch.from_numpy(host).to(self.device)
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
        self._stage("deblock_host_planes")
        dev = self.device
        planes = [torch.as_tensor(a, device=dev) for a in (
            np.asarray(mb_class, np.int32), self._out_qp.astype(np.int32),
            nnz, mv_cells.astype(np.int32))]
        self._stage("deblock_upload")
        self.ref = _deblock_recon(
            self.mb_w, self.mb_h, *self.ref, *planes, self._slice_id,
            self.deblock_idc, stage=self._stage)

    # -- frame paths ------------------------------------------------------
    def _encode_i(self, buf):
        """An IDR: the intra wavefront (_i_frame), the fetch of its symbol
        rows, the write. On the per-MB QP plane the write takes mb_qp and
        the reference is filtered after it (_apply_deblock)."""
        n = self.mb_w * self.mb_h
        aq = self._per_mb_qp
        self.encodes.append(("I", "aq" if aq else "fused", self._cur_is_ref,
                             n))
        with trace.span("enc.qp_maps"):
            qp_d, qpc_d = self._qp_maps(buf[:self.mb_h * 16])
        with trace.span("enc.idr"):
            rows_d, *rec = _i_frame(
                self.mb_w, self.mb_h, 1 if aq else self.deblock_idc, buf,
                qp_d, qpc_d, qp_d, self._slice_id, self._row_slice_np,
                self._stage)
        self.ref = tuple(rec)
        with trace.span("enc.to_host"):
            rows = _fetch(rows_d)            # the frame's one symbol fetch
            self._stage("fetch")
            _, cls, planes = _unpack(rows)
        mb_class = np.where(cls == 0, 0, 1).astype(np.uint8)
        mv = np.zeros((n, 2), np.int16)
        # n_refs on an IDR only sizes the SPS DPB (max_num_ref_frames);
        # the per-MB QP path predicts from one reference
        with trace.span("enc.write"):
            data = self._write(1, mb_class, mv, **planes,
                               mb_qp=self._qp_plane,
                               n_refs=1 if aq else self.refs)
        if aq:
            with trace.span("enc.finish"):
                self._apply_deblock(mb_class, planes["luma_ac"], mv)
        return data

    def _encode_p(self, buf):
        """A P frame: the analysis (_p_analyze), the fetch of its inter
        MBs' rows (_p_rows, which hold the intra-fallback mask), then where
        MBs fell back the intra fixup (_p_intra_fixup) and the fetch of the
        merged rows, or else, on a reference frame, the recon (_p_finish);
        then the host tail (_write_p). The per-MB QP path predicts from one reference,
        runs the steps without their deblock (idc 1), writes with mb_qp,
        then filters self.ref with the writer's QP chain (_apply_deblock);
        like JaxEncoder, on a non-reference frame too, where self.ref is
        still the previous reference (ROADMAP §3)."""
        aq = self._per_mb_qp
        idc = 1 if aq else self.deblock_idc
        refs = [self.ref]
        if not aq and self.refs == 2 and self._ref2 is not None:
            refs.append(self._ref2)
        with trace.span("enc.qp_maps"):
            qp_d, qpc_d = self._qp_maps(buf[:self.mb_h * 16])
        (packed_d, tile_y, tile_u, tile_v, Yd, Ud, Vd, use_intra_d, cls_d,
         nnz_d, mvc_d, refc_d) = _p_analyze(
            self.mb_w, self.mb_h, self.ME_RADIUS, buf,
            *(torch.stack(p) for p in zip(*refs)), qp_d, qpc_d,
            self._scroll_dy, self.trellis_lam, self._stage)
        intra_rows = rec = None
        with trace.span("enc.to_host"):
            # the inter MBs' rows, the frame's unless MBs fell back
            rows = _unpack(_fetch(_p_rows(packed_d)))
            use_intra = rows[0]["use_intra"] != 0
            self._stage("fetch")
        self.encodes.append(("P", "aq" if aq else "fused", self._cur_is_ref,
                             int(use_intra.sum())))
        if use_intra.any():
            with trace.span("enc.intra_fixup"):
                intra_rows, *rec = _p_intra_fixup(
                    self.mb_w, self.mb_h, idc, Yd, Ud, Vd, tile_y, tile_u,
                    tile_v, use_intra, use_intra_d, cls_d, nnz_d, mvc_d,
                    refc_d, qp_d, qpc_d, qp_d, self._slice_id,
                    self._row_slice_np, self._stage)
            with trace.span("enc.to_host"):
                rows = _unpack(_fetch(_p_rows(packed_d, use_intra_d,
                                              intra_rows)))
                self._stage("fetch")
        elif self._cur_is_ref:
            # a non-reference frame (T1) never becomes a reference: no
            # recon for it
            with trace.span("enc.finish"):
                rec = _p_finish(self.mb_w, self.mb_h, idc, tile_y, tile_u,
                                tile_v, cls_d, nnz_d, mvc_d, refc_d, qp_d,
                                self._slice_id, self._stage)
        if self._cur_is_ref:
            if not aq:
                self._ref2 = self.ref if self.refs == 2 else None
            self.ref = tuple(rec)
        with trace.span("enc.write"):
            data, mb_class, mv = self._write_p(*rows, len(refs),
                                               self._qp_plane)
        if aq:
            meta, _, planes = rows
            with trace.span("enc.finish"):
                self._apply_deblock(mb_class, planes["luma_ac"], mv,
                                    meta["mv8"])
        return data

    def _write_p(self, meta, cls, planes, n_refs, mb_qp=None):
        """The host tail of every P frame, from its fetched [n, META_W +
        427] rows (_p_rows) as _unpack views them: MB classes, P_Skip where
        the residual is zero, the reference the first and the MV the
        writer's skip predictor, the write. Returns (bytes, the MB
        classes, the MVs)."""
        use_intra = meta["use_intra"] != 0
        part = meta["part"]
        mv8 = np.ascontiguousarray(meta["mv8"], np.int16)
        ref_plane = np.ascontiguousarray(meta["ref_idx"], np.int8)
        ref_plane[use_intra] = 0
        mv = np.array(meta["mv"], np.int16)
        mv[use_intra] = 0
        # part -> MbClass: 0/1/2/3 = P16x16/P16x8/P8x16/P8x8 (3/4/5/6)
        mb_class = np.where(use_intra, 1, 3 + part).astype(np.uint8)
        skip_pred, _ = self._mv_preds(mb_class, mv, mv8, ref_plane)
        is_skip = ((meta["no_res"] != 0) & ~use_intra & (part == 0)
                   & (ref_plane == 0) & (mv == skip_pred).all(1))
        mb_class[is_skip] = 11
        mb_class[use_intra & (cls == 0)] = 0  # I4x4 fallback MBs
        return (self._write(0, mb_class, mv, **planes, mb_qp=mb_qp, mv8=mv8,
                            n_refs=n_refs, ref_plane=ref_plane),
                mb_class, mv)

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
        with trace.span("enc.frame", frame=trace.new_frame()):
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
            with trace.span("enc.upload"):
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
            if self.ltr and self._cur_is_ref and (is_idr
                                                  or self._mark_ltr_next):
                self._ltr_ref = self.ref  # this frame's recon is the LTR
                self._mark_ltr_next = False
            if self._cur_is_ref:  # 7.4.3: frame_num advances per ref frame
                self._frame_num = (self._frame_num + 1) & 0xff
            if self.rc is not None:
                self.rc.update(8 * len(data))
            self._prev_src = cur_src
            self.frame_idx += 1
            trace.count("enc.frames")
            return data

    def _write_p_packed(self, packed, frame=None):
        """Host entropy tail of a run's P frame: `packed` is its
        [n, META_W + 427] int16 rows (_p_batch); `frame` its trace frame
        id."""
        with trace.span("enc.writer.unpack", frame=frame):
            rows = _unpack(packed)
        with trace.span("enc.writer.write", frame=frame):
            return self._write_p(*rows, 1)[0]

    def _dispatch_p_run(self, frames):
        """Chain K consecutive P frames on the device (_p_batch); self.ref
        advances to the run's last recon. Returns the frames' rows for
        _drain_p_run, whose copies to the host may still be in flight."""
        with trace.span("enc.upload"):
            bufs = torch.stack([self._upload(*f) for f in frames])
        if self.denoise:
            for buf in bufs:
                self._denoise(buf)
        with trace.span("enc.qp_maps"):
            qp_d, qpc_d = self._qp_maps()
        rows, self.ref = _p_batch(
            self.mb_w, self.mb_h, self.ME_RADIUS, self.deblock_idc, bufs,
            *self.ref, qp_d, qpc_d, self._slice_id, self._row_slice_np,
            self.trellis_lam)
        return rows

    def _drain_p_run(self, rows, frame=None):
        """Host half of a dispatched run, on encode_frames' writer thread:
        per frame, wait for its rows, write its slices, then advance
        frame_idx and _frame_num (every frame of a run is a reference).
        The main thread touches none of the state this reads or writes
        while a drain runs. `frame`: the run's trace frame id."""
        out = []
        for packed, ready, _ in rows:
            with trace.span("enc.writer.rows_wait", frame=frame):
                if ready is not None:
                    ready.synchronize()
            t0 = time.perf_counter()
            out.append(self._write_p_packed(packed.numpy(), frame))
            self.prof["entropy_ms"] += (time.perf_counter() - t0) * 1e3
            self._frame_num = (self._frame_num + 1) & 0xff
            self.frame_idx += 1
            trace.count("enc.frames")
        self.prof["frames"] += len(rows)
        return out

    @property
    def _batchable(self):
        """Configurations whose P frames encode_frames runs in batches (as
        JaxEncoder._batchable): the fused path with a flat QP, one
        short-term reference and every frame a reference, with no
        per-frame host decision in between."""
        return (not self.intra_only and not self.aq and not self.gom_rc
                and self.rc is None and not self.scene_cut
                and self.refs == 1 and self.temporal_layers == 1
                and not self.ltr and not self.bgd and not self.scroll_me
                and not self.slice_max_bytes)

    def encode_frames(self, frames, batch=8):
        """Encode a sequence of (Y, U, V) frames, with the bytes of
        per-frame encode_frame calls (JaxEncoder.encode_frames). When the
        configuration allows (_batchable), each full run of `batch`
        consecutive P frames (the same IDR / gop / force_intra_frame
        segmentation as JAX) is chained on the device by _dispatch_p_run
        and written by _drain_p_run on a writer thread: the native
        writer is a ctypes call, which lets go of the interpreter lock,
        so run N's entropy writing overlaps run N+1's device work (JAX
        gets the same overlap from asynchronous dispatch, at most one run
        ahead; so does this). IDRs and shorter runs take encode_frame.
        `encodes` lists every encode of the call, a run's frames with path
        "run"."""
        frames = list(frames)
        if not self._batchable:
            return [self.encode_frame(*f) for f in frames]
        out, log, pending = [], [], []
        fidx = self.frame_idx   # segmentation-time frame counter
        have_ref = self.ref is not None

        def drain(keep=0):
            while len(pending) > keep:
                with trace.span("enc.writer_wait"):
                    t0 = time.perf_counter()
                    out.extend(pending.pop(0).result())
                    self.prof["writer_wait_ms"] += (time.perf_counter()
                                                    - t0) * 1e3

        def one(f):
            drain()
            out.append(self.encode_frame(*f))
            log.extend(self.encodes)

        with ThreadPoolExecutor(max_workers=1) as writer:
            i = 0
            while i < len(frames):
                # _force_idr only affects the next encode_frame call,
                # which consumes (clears) it
                if (not have_ref or self._force_idr
                        or (self.gop and fidx % self.gop == 0)):
                    one(frames[i])
                    fidx += 1
                    have_ref = True
                    i += 1
                    continue
                k = 1
                while (i + k < len(frames) and k < batch
                       and not (self.gop and (fidx + k) % self.gop == 0)):
                    k += 1
                if k < batch:
                    for f in frames[i:i + k]:
                        one(f)
                else:
                    run = trace.new_frame()
                    with trace.span("enc.run", frame=run):
                        rows = self._dispatch_p_run(frames[i:i + k])
                    log += [("P", "run", True, n) for _, _, n in rows]
                    pending.append(writer.submit(self._drain_p_run, rows,
                                                 run))
                    drain(keep=1)
                fidx += k
                i += k
            drain()
        self.encodes = log
        return out

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
