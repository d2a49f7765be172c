"""H.264 frame reconstruction on PyTorch (one frame at a time).

Port of losslessh264_tpu/decoder_jax.py's per-frame path. Per frame:
residuals (dequant + IDCT, batched over the frame), inter prediction
(bucketed dense-shift MC over the K1 half-pel planes, or the general
per-cell gather), the intra wavefront (plain torch, one batched step
per slope-2 MB diagonal) and the deblocking wavefront (the K2 kernel on
CUDA). The DPB ring lives on the device.

Left out on purpose (TPU workarounds of JaxDecoder): the sparse
upload (_sparsify_run / _densify_planes), the scanned/vmapped runs
(recon_run, recon_intra_batch, INTRA_BATCH), the pow2/16-row sparse
intra tables (_intra_scan_sparse) and int8 narrowing of uploads.

Validated frame-exact against decoder_np.NpDecoder and the JAX stages
(tests/test_torch_decoder.py).
"""
from __future__ import annotations

import numpy as np
import torch

from . import native
from . import ref_np
from .ops import deblock as tdb
from .ops import intra as tintra
from .ops import mc as tmc
from .ops import transform as tt
from .ops.wavefront import diagonals

PAD = 32          # reference-plane padding (luma)
WPAD = 8          # working-plane padding for wavefront gathers
BLK = tintra.BLK_ORDER

# static per-block above-right availability kind for I4x4 decode order:
# 0 = never, 1 = always (in-MB), 2 = needs MB availT, 3 = needs MB availTR
_I4_TR_KIND = np.zeros(16, np.int64)
for _d, _r in enumerate(BLK):
    _by, _bx = divmod(int(_r), 4)
    if _by == 0:
        _I4_TR_KIND[_r] = 2 if _bx < 3 else 3
    elif _bx == 3:
        _I4_TR_KIND[_r] = 0
    else:
        _nb = (_by - 1) * 4 + _bx + 1
        _I4_TR_KIND[_r] = 1 if list(BLK).index(_nb) < _d else 0

# plane-dict entries that stay on the host: the bucketed MC's unique
# (slot, mv) table and slot list drive host-side slicing
HOST_KEYS = ("mc_uniq", "mc_slots")


def planes_to_torch(planes_np, device):
    """The numpy plane dict of TorchDecoder._prep_planes (the keys of
    JaxDecoder._prep_planes) as tensors on `device`: arrays become
    tensors, 0-d values Python scalars, lists lists of tensors, and
    HOST_KEYS stay numpy."""
    out = {}
    for k, v in planes_np.items():
        if isinstance(v, list):
            out[k] = [torch.as_tensor(np.asarray(a), device=device)
                      for a in v]
        elif k in HOST_KEYS:
            out[k] = np.asarray(v)
        elif np.ndim(v) == 0:
            out[k] = v.item() if hasattr(v, "item") else v
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def ring_to_torch(ring_np, device):
    """A numpy reference ring [R, Hp, Wp] uint8 as a device tensor."""
    return torch.from_numpy(np.ascontiguousarray(ring_np, np.uint8)) \
        .to(device)


def _repeat2(a, t):
    return a.repeat_interleave(t, 0).repeat_interleave(t, 1)


# ---------------------------------------------------------------------------
# per-MB intra reconstruction (batched over the lanes of one diagonal)
# ---------------------------------------------------------------------------
def _recon_mb_luma(loc, res, cls, i4_modes, i16_mode, t8, aL, aT, aTL, aTR):
    """loc: [K,17,25] local luma contexts (row 0 = top, col 0 = left,
    interior to be filled); res: [K,16,16] residuals. Returns the
    [K,16,16] interiors: every lane computes I16, I4x4 and I8x8 and
    selects by its class."""
    K = loc.shape[0]
    dev = loc.device
    lanes = torch.arange(K, device=dev)
    yes = torch.ones(K, dtype=torch.bool, device=dev)
    interior = loc[:, 1:17, 1:17]

    preds16 = tintra.pred16_all(loc[:, 1:17, 0], loc[:, 0, 1:17],
                                loc[:, 0, 0], aL, aT)
    tile_i16 = torch.clamp(
        preds16[lanes, torch.clamp(i16_mode, 0, 3).long()] + res, 0, 255)

    # ---- I4x4: sequential 16 blocks over the local buffer ----
    buf = loc.clone()
    keep4 = torch.arange(8, device=dev) < 4
    for d in range(16):
        r = int(BLK[d])
        by, bx = divmod(r, 4)
        ly, lx = 1 + by * 4, 1 + bx * 4
        leftv = buf[:, ly:ly + 4, lx - 1]
        topv = buf[:, ly - 1, lx:lx + 8]
        tl = buf[:, ly - 1, lx - 1]
        kind = _I4_TR_KIND[r]
        if kind != 1:
            trv = {0: ~yes, 2: aT, 3: aTR}[int(kind)]
            topv = torch.where(keep4[None, :] | trv[:, None], topv,
                               topv[:, 3:4])
        preds = tintra.pred4_all(leftv, topv, tl, aL if bx == 0 else yes,
                                 aT if by == 0 else yes)
        mode = torch.clamp(i4_modes[:, r], 0, 8).long()
        buf[:, ly:ly + 4, lx:lx + 4] = torch.clamp(
            preds[lanes, mode]
            + res[:, by * 4:by * 4 + 4, bx * 4:bx * 4 + 4], 0, 255)
    tile_i4 = buf[:, 1:17, 1:17]

    # ---- I8x8: 4 sequential blocks ----
    buf = loc.clone()
    keep8 = torch.arange(16, device=dev) < 8
    for b8 in range(4):
        by, bx = divmod(b8, 2)
        ly, lx = 1 + by * 8, 1 + bx * 8
        leftv = buf[:, ly:ly + 8, lx - 1]
        topv = buf[:, ly - 1, lx:lx + 16]
        tl = buf[:, ly - 1, lx - 1]
        trv, tlv_a = ((aT, aTL), (aTR, aT), (yes, aL), (~yes, yes))[b8]
        topv = torch.where(keep8[None, :] | trv[:, None], topv, topv[:, 7:8])
        preds = tintra.pred8_all(leftv, topv, tl, aL if bx == 0 else yes,
                                 aT if by == 0 else yes, tlv_a)
        mode = torch.clamp(i4_modes[:, (0, 2, 8, 10)[b8]], 0, 8).long()
        buf[:, ly:ly + 8, lx:lx + 8] = torch.clamp(
            preds[lanes, mode]
            + res[:, by * 8:by * 8 + 8, bx * 8:bx * 8 + 8], 0, 255)
    tile_i8 = buf[:, 1:17, 1:17]

    c = cls[:, None, None]
    return torch.where(c == 1, tile_i16,
                       torch.where(c == 2, tile_i8,
                                   torch.where(c == 0, torch.where(
                                       t8[:, None, None] != 0, tile_i8,
                                       tile_i4), interior)))


def _recon_mb_chroma(locc, resc, cls, cmode, aL, aT):
    """locc: [K,9,9]; resc: [K,8,8]. Returns [K,8,8] interiors."""
    K = locc.shape[0]
    preds = tintra.pred_chroma_all(locc[:, 1:9, 0], locc[:, 0, 1:9],
                                   locc[:, 0, 0], aL, aT)
    tile = torch.clamp(
        preds[torch.arange(K, device=locc.device),
              torch.clamp(cmode, 0, 3).long()] + resc, 0, 255)
    is_intra = (cls == 0) | (cls == 1) | (cls == 2)
    return torch.where(is_intra[:, None, None], tile, locc[:, 1:9, 1:9])


# ---------------------------------------------------------------------------
# frame reconstruction stages
# ---------------------------------------------------------------------------
def _weighted(pred, w, o, d):
    """Explicit weighted prediction sample (8.4.2.3); d < 0 = off."""
    d0 = torch.clamp(d, min=0)
    rnd = torch.ones_like(d) << torch.clamp(d - 1, min=0)
    wv = torch.where(d >= 1, ((pred * w + rnd) >> d0) + o, pred * w + o)
    return torch.where(d >= 0, torch.clamp(wv, 0, 255), pred)


def _mc_legacy_cells(mb_w, mb_h, p, ref_y, ref_u, ref_v):
    """General per-cell MC (gather path): exact for every legal stream —
    arbitrary per-cell MVs/refs, iFullMV clipping, explicit weighted
    prediction. Returns per-MB tiles ([n,16,16], [n,8,8], [n,8,8])."""
    n = mb_w * mb_h
    dev = ref_y.device
    mbi = torch.arange(n, device=dev)
    cell = torch.arange(16, device=dev)
    cy0 = ((mbi // mb_w) * 16)[:, None] + ((cell // 4) * 4)[None, :]
    cx0 = ((mbi % mb_w) * 16)[:, None] + ((cell % 4) * 4)[None, :]
    cy0, cx0 = cy0.reshape(-1), cx0.reshape(-1)
    refp = p["ref_slot"].reshape(-1).to(torch.int32)
    mvx = p["mv"][:, :, 0].reshape(-1)
    mvy = p["mv"][:, :, 1].reshape(-1)
    refc = torch.clamp(refp, 0, ref_y.shape[0] - 1)
    pred_cells = tmc.mc_luma_cells(ref_y, PAD, refc, cy0, cx0, mvx, mvy)
    predc = [tmc.mc_chroma_cells(r, PAD // 2, refc, cy0 // 2, cx0 // 2,
                                 mvx, mvy) for r in (ref_u, ref_v)]
    # explicit weighted prediction, between MC and residual add. Luma:
    # per cell. Chroma: only the reference decoder's quarter-size region
    # (wp_cmask) — parity with rec_mb.cpp WeightPrediction. WP frames
    # always take this path (mc_fast_plan is never used with WP).
    has_wp = "wp_luma" in p
    if has_wp:
        wpl = p["wp_luma"].reshape(-1, 3).to(torch.int32)
        pred_cells = _weighted(pred_cells, wpl[:, 0, None, None],
                               wpl[:, 1, None, None], wpl[:, 2, None, None])

    pred_y_mb = pred_cells.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)
    pred_c_mb = [c.reshape(n, 4, 4, 2, 2).permute(0, 1, 3, 2, 4)
                 .reshape(n, 8, 8) for c in predc]
    if has_wp:
        r8 = torch.arange(8, device=dev)
        cell_of_px = (r8[:, None] // 2) * 4 + r8[None, :] // 2
        cmask = p["wp_cmask"].reshape(n, 8, 8) > 0
        for i, key in enumerate(("wp_cb", "wp_cr")):
            wp = p[key].to(torch.int32)
            d = wp[:, cell_of_px, 2]
            pred_c_mb[i] = torch.where(
                cmask, _weighted(pred_c_mb[i], wp[:, cell_of_px, 0],
                                 wp[:, cell_of_px, 1], d), pred_c_mb[i])
    return pred_y_mb, pred_c_mb[0], pred_c_mb[1]


def _tiles_to_plane(tiles, mb_w, mb_h, t):
    return tiles.reshape(mb_h, mb_w, t, t).permute(0, 2, 1, 3) \
        .reshape(mb_h * t, mb_w * t)


def _plane_to_tiles(plane, mb_w, mb_h, t):
    return plane.reshape(mb_h, t, mb_w, t).permute(0, 2, 1, 3) \
        .reshape(mb_w * mb_h, t, t)


def _residual_and_inter(mb_w, mb_h, p, ref_y, ref_u, ref_v):
    """Residuals of every MB, plus inter prediction: the bucketed
    dense-shift path when the host plan served the frame (mc_fast), the
    general per-cell path otherwise. Returns the WPAD-padded int32
    working planes with inter MBs reconstructed (0 elsewhere) and the
    residual tiles."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    dev = ref_y.device
    cls = p["mb_class"].to(torch.int32)
    qp = p["qp"].to(torch.int32)
    flat4 = torch.full((4, 4), 16, dtype=torch.int32, device=dev)
    flat8 = torch.full((8, 8), 16, dtype=torch.int32, device=dev)
    w4 = [w.to(torch.int32) if p["use_scaling"] else flat4 for w in p["w4"]]
    w8 = [w.to(torch.int32) if p["use_scaling"] else flat8 for w in p["w8"]]
    luma8 = (p["luma8"] if "luma8" in p
             else torch.zeros((n, 4, 8, 8), dtype=torch.int32, device=dev))
    res_y = tt.luma_residuals(cls, qp, p["cbp_luma"], p["transform8"],
                              p["luma_ac"], p["luma_dc"], luma8,
                              w4[0], w4[3], w8[0], w8[1])
    res_u, res_v = tt.chroma_residuals(
        cls, qp, p["cbp_chroma"], p["chroma_ac"], p["chroma_dc"],
        p["chroma_qp_offset"], p["second_chroma_qp_offset"],
        w4[1], w4[2], w4[4], w4[5])

    # ---- inter prediction (whole-frame planes) ----
    valid = p["ref_slot"].reshape(-1) >= 0
    if "mc_bucket" in p and not p["mc_any"]:
        pred_y = torch.zeros((H, W), dtype=torch.int32, device=dev)
        pred_u = torch.zeros((H // 2, W // 2), dtype=torch.int32, device=dev)
        pred_v = torch.zeros_like(pred_u)
    elif "mc_bucket" in p and p["mc_fast"]:
        pred_y, pred_u, pred_v = tmc.mc_bucketed(ref_y, ref_u, ref_v, PAD, p,
                                                 mb_w, mb_h)
    else:
        ty, tu, tv = _mc_legacy_cells(mb_w, mb_h, p, ref_y, ref_u, ref_v)
        pred_y = _tiles_to_plane(ty, mb_w, mb_h, 16)
        pred_u = _tiles_to_plane(tu, mb_w, mb_h, 8)
        pred_v = _tiles_to_plane(tv, mb_w, mb_h, 8)

    inter_mb = valid.reshape(n, 16).all(1).reshape(mb_h, mb_w)
    im_y = _repeat2(inter_mb, 16)
    im_c = _repeat2(inter_mb, 8)
    py = torch.where(im_y, torch.clamp(
        pred_y + _tiles_to_plane(res_y, mb_w, mb_h, 16), 0, 255), 0)
    pu = torch.where(im_c, torch.clamp(
        pred_u + _tiles_to_plane(res_u, mb_w, mb_h, 8), 0, 255), 0)
    pv = torch.where(im_c, torch.clamp(
        pred_v + _tiles_to_plane(res_v, mb_w, mb_h, 8), 0, 255), 0)
    # PCM overlay (plane omitted on PCM-free frames)
    if "pcm" in p:
        pcm = p["pcm"].to(torch.int32)
        is_pcm = (cls == 8).reshape(mb_h, mb_w)
        py = torch.where(_repeat2(is_pcm, 16), _tiles_to_plane(
            pcm[:, :256].reshape(n, 16, 16), mb_w, mb_h, 16), py)
        pu = torch.where(_repeat2(is_pcm, 8), _tiles_to_plane(
            pcm[:, 256:320].reshape(n, 8, 8), mb_w, mb_h, 8), pu)
        pv = torch.where(_repeat2(is_pcm, 8), _tiles_to_plane(
            pcm[:, 320:384].reshape(n, 8, 8), mb_w, mb_h, 8), pv)

    # place into padded working planes
    Yw = torch.zeros((H + 2 * WPAD, W + 2 * WPAD), dtype=torch.int32,
                     device=dev)
    Uw = torch.zeros((H // 2 + 2 * WPAD, W // 2 + 2 * WPAD),
                     dtype=torch.int32, device=dev)
    Vw = torch.zeros_like(Uw)
    Yw[WPAD:WPAD + H, WPAD:WPAD + W] = py
    Uw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2] = pu
    Vw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2] = pv
    return Yw, Uw, Vw, res_y, res_u, res_v


def _intra_scan(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u, res_v, p, diags):
    """Compact-carry intra wavefront over the FULL diagonal table
    `diags` (numpy [nd, K], -1 padding): one batched step per diagonal.

    The carried state is only what the wavefront needs: the
    last-completed bottom row per pixel column (top_*), the
    last-completed right column per MB row (left_*), and the saved
    above-left corners (tl_*, rescued before the left-neighbour MB's
    write clobbers them). Every MB of a diagonal updates the buffers
    (inter MBs feed intra neighbours too), so a skipped diagonal would
    starve them. Each buffer carries one trailing scratch element (row
    for left_*) where dead lanes write — never a clamped live slot.
    Tiles are collected per step and reassembled into the planes once.
    Returns the planes with every intra MB reconstructed."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    dev = Yw.device
    i32 = torch.int32
    cls = p["mb_class"].to(i32)
    avail = p["avail"]  # [n,4] bool: L, T, TL, TR
    t8 = p["transform8"].to(i32)
    i4m = p["i4_modes"].to(i32)
    i16m = p["i16_mode"].to(i32)
    cmode = p["chroma_mode"].to(i32)
    is_intra = (cls == 0) | (cls == 1) | (cls == 2)

    in_y = _plane_to_tiles(Yw[WPAD:WPAD + H, WPAD:WPAD + W], mb_w, mb_h, 16)
    in_u = _plane_to_tiles(Uw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2],
                           mb_w, mb_h, 8)
    in_v = _plane_to_tiles(Vw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2],
                           mb_w, mb_h, 8)

    # carried context buffers (+pad so column -1 / TR overhang reads land
    # on zeros — matching the zero WPAD border of the plane form), each
    # with one trailing scratch element for dead-lane writes
    PADL, PADR = 1, 8
    LY, LC = W + PADL + PADR, W // 2 + PADL + PADR

    def z(*shape):
        return torch.zeros(shape, dtype=i32, device=dev)

    top = {"y": z(LY + 1), "u": z(LC + 1), "v": z(LC + 1)}
    left = {"y": z(mb_h + 1, 16), "u": z(mb_h + 1, 8), "v": z(mb_h + 1, 8)}
    tlb = {"y": z(mb_w + 2), "u": z(mb_w + 2), "v": z(mb_w + 2)}
    o25 = torch.arange(25, device=dev)
    o9 = torch.arange(9, device=dev)
    o16 = torch.arange(16, device=dev)
    o8 = torch.arange(8, device=dev)

    def scat(buf, cols, vals, m, length):
        idx = cols[:, None] + (o16 if m == 16 else o8)[None, :]
        idx = torch.where(idx < length, idx, length)   # past the end: drop
        buf[idx.reshape(-1)] = vals.reshape(-1)

    diags_t = torch.tensor(diags, device=dev).long()
    Ty, Tu, Tv = [], [], []
    for d in range(diags_t.shape[0]):
        mb_list = diags_t[d]
        mb_c = torch.clamp(mb_list, 0, n - 1)
        mby = mb_c // mb_w
        mbx = mb_c % mb_w
        K = mb_c.shape[0]

        # each lane's [17,25] luma / [9,9] chroma context from the
        # compact buffers (row 0 = top incl. TL corner + TR overhang,
        # col 0 = left), interior seeded with the input tile
        loc = z(K, 17, 25)
        loc[:, 0, :] = top["y"][(mbx * 16 + PADL - 1)[:, None] + o25]
        loc[:, 0, 0] = tlb["y"][mbx]
        loc[:, 1:, 0] = left["y"][mby]
        loc[:, 1:, 1:17] = in_y[mb_c]
        locc = {}
        for c, inp in (("u", in_u), ("v", in_v)):
            lc = z(K, 9, 9)
            lc[:, 0, :] = top[c][(mbx * 8 + PADL - 1)[:, None] + o9]
            lc[:, 0, 0] = tlb[c][mbx]
            lc[:, 1:, 0] = left[c][mby]
            lc[:, 1:, 1:] = inp[mb_c]
            locc[c] = lc

        av = avail[mb_c]
        cl = cls[mb_c]
        tiles = _recon_mb_luma(loc, res_y[mb_c], cl, i4m[mb_c], i16m[mb_c],
                               t8[mb_c], av[:, 0], av[:, 1], av[:, 2],
                               av[:, 3])
        tus = _recon_mb_chroma(locc["u"], res_u[mb_c], cl, cmode[mb_c],
                               av[:, 0], av[:, 1])
        tvs = _recon_mb_chroma(locc["v"], res_v[mb_c], cl, cmode[mb_c],
                               av[:, 0], av[:, 1])
        live = mb_list >= 0
        do = (live & is_intra[mb_c])[:, None, None]
        tiles = torch.where(do, tiles, in_y[mb_c])
        tus = torch.where(do, tus, in_u[mb_c])
        tvs = torch.where(do, tvs, in_v[mb_c])

        # buffer updates from the FINAL tiles. Order inside one step:
        # the reads above used the OLD buffers; save the above-left
        # corners the NEXT diagonal's right neighbours need BEFORE this
        # step's top rows overwrite them
        tidx = torch.where(live, mbx + 1, mb_w + 1)
        tlb["y"][tidx] = top["y"][torch.clamp(mbx * 16 + 16 + PADL - 1,
                                              0, LY - 1)]
        for c in ("u", "v"):
            tlb[c][tidx] = top[c][torch.clamp(mbx * 8 + 8 + PADL - 1,
                                              0, LC - 1)]
        scat(top["y"], torch.where(live, mbx * 16 + PADL, W + PADL),
             tiles[:, 15, :], 16, LY)
        ccol = torch.where(live, mbx * 8 + PADL, W // 2 + PADL)
        scat(top["u"], ccol, tus[:, 7, :], 8, LC)
        scat(top["v"], ccol, tvs[:, 7, :], 8, LC)
        # dead lanes target the scratch row, never a clamped live one
        lrow = torch.where(live, mby, mb_h)
        left["y"][lrow] = tiles[:, :, 15]
        left["u"][lrow] = tus[:, :, 7]
        left["v"][lrow] = tvs[:, :, 7]
        Ty.append(tiles)
        Tu.append(tus)
        Tv.append(tvs)

    # reassembly: every diagonal lane's tile back to its MB slot (dead
    # lanes land in scratch slot n)
    flat_mb = diags_t.reshape(-1)
    ok = flat_mb >= 0
    tgt = torch.where(ok, torch.clamp(flat_mb, 0, n - 1), n)

    def put(base, T, t):
        out = z(n + 1, t, t)
        out[tgt] = torch.cat(T)
        covered = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        covered[tgt] = ok
        return torch.where(covered[:n, None, None], out[:n], base)

    Yw, Uw, Vw = Yw.clone(), Uw.clone(), Vw.clone()
    Yw[WPAD:WPAD + H, WPAD:WPAD + W] = _tiles_to_plane(
        put(in_y, Ty, 16), mb_w, mb_h, 16)
    Uw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2] = _tiles_to_plane(
        put(in_u, Tu, 8), mb_w, mb_h, 8)
    Vw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2] = _tiles_to_plane(
        put(in_v, Tv, 8), mb_w, mb_h, 8)
    return Yw, Uw, Vw


def _crop(mb_w, mb_h, Yw, Uw, Vw):
    H, W = mb_h * 16, mb_w * 16
    return (Yw[WPAD:WPAD + H, WPAD:WPAD + W].to(torch.uint8),
            Uw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2].to(torch.uint8),
            Vw[WPAD:WPAD + H // 2, WPAD:WPAD + W // 2].to(torch.uint8))


def _deblock_crop(mb_w, mb_h, Yw, Uw, Vw, p):
    """Deblocking wavefront (K2 on CUDA), then crop to uint8 planes.
    bS compares raw ref indices (reference MB_BS_MV semantics), not
    resolved pictures — see decsupport.h FramePlanes::ref_idx."""
    Yw, Uw, Vw = tdb.deblock_frame(
        mb_w, mb_h, Yw, Uw, Vw, p["mb_class"], p["qp"], p["nnz"], p["mv"],
        p["ref_idx"], p["slice_id"], p["deblock_idc"], p["alpha_off"],
        p["beta_off"], p["transform8"], p["chroma_qp_offset"])
    return _crop(mb_w, mb_h, Yw, Uw, Vw)


def _edge_pad(x, pad):
    """Edge (replicate) padding of the last two dims by clamped indexing:
    F.pad's replicate mode does not take uint8."""
    H, W = x.shape[-2:]
    dev = x.device
    ri = torch.clamp(torch.arange(-pad, H + pad, device=dev), 0, H - 1)
    ci = torch.clamp(torch.arange(-pad, W + pad, device=dev), 0, W - 1)
    return x[..., ri[:, None], ci[None, :]]


def _store_ref(ref_y, ref_u, ref_v, Y, U, V, slot):
    """Edge-pad the new frame and write it into ring slot `slot`, in
    place (the reference's DPB store + border expansion,
    decoder_core.cpp:2361-2377)."""
    ref_y[slot] = _edge_pad(Y, PAD)
    ref_u[slot] = _edge_pad(U, PAD // 2)
    ref_v[slot] = _edge_pad(V, PAD // 2)


# ---------------------------------------------------------------------------
# stream decoder
# ---------------------------------------------------------------------------
class TorchDecoder:
    """Decode a .264 byte stream to YUV frames on one torch device.

    The DPB lives on the device: the reference rings are uint8 tensors
    updated in place; only the per-frame symbol planes are uploaded, and
    the yielded (Y, U, V) uint8 tensors stay on the device. The host
    decodes symbols (native.SymbolDecoder) and plans each frame.
    device="cuda" (the default) raises when no GPU is present; there is
    no fallback to the CPU.
    """

    MAX_REFS = 18   # 16 DPB refs + previous output (EC) + incoming

    def __init__(self, data: bytes, device="cuda",
                 error_concealment: bool = True,
                 ec_mode: str = "mv_copy_freeze"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchDecoder: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        self.sym = native.SymbolDecoder(data)
        self.slot_of = {}   # output_idx -> ring slot
        self.ref_y = None
        self.ref_u = None
        self.ref_v = None
        self.out_idx = 0
        self.concealed = 0
        self.crop_px = (0, 0, 0, 0)
        # error concealment matches NpDecoder: MV-copy with freeze-output
        # by default (the reference h264dec default, decoder_core.cpp
        # bFreezeOutput); the per-MB policy runs on the host via
        # ref_np.conceal_undecoded over fetched planes
        self._ec = error_concealment
        self._ec_mode = ec_mode if error_concealment else None
        self._frozen = error_concealment and ec_mode == "mv_copy_freeze"

    def _prep_refs(self, mb_w, mb_h):
        H, W = mb_h * 16, mb_w * 16
        if self.ref_y is None or self.ref_y.shape[1] != H + 2 * PAD:
            # +1 slot keeps the JAX ring layout (its scratch slot)
            self.ref_y = torch.zeros(
                (self.MAX_REFS + 1, H + 2 * PAD, W + 2 * PAD),
                dtype=torch.uint8, device=self.device)
            self.ref_u = torch.zeros(
                (self.MAX_REFS + 1, H // 2 + PAD, W // 2 + PAD),
                dtype=torch.uint8, device=self.device)
            self.ref_v = torch.zeros_like(self.ref_u)
            self.slot_of = {}

    def frames(self):
        it = iter(self.sym)
        while True:
            try:
                f = next(it)
            except StopIteration:
                return
            except RuntimeError:
                # unrecoverable symbol-layer error mid-stream: repeat the
                # last output once and end (NpDecoder contract)
                if not self._ec or self.out_idx == 0:
                    raise
                self.concealed += 1
                prev = self.slot_of.get(self.out_idx - 1)
                if prev is None or self._frozen:
                    return
                cp = PAD // 2
                yield (self.ref_y[prev][PAD:-PAD, PAD:-PAD],
                       self.ref_u[prev][cp:-cp, cp:-cp],
                       self.ref_v[prev][cp:-cp, cp:-cp])
                return
            yield from self._decode_one(f)

    def _decode_one(self, f):
        self.crop_px = f.get("crop_px", (0, 0, 0, 0))
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        self._prep_refs(mb_w, mb_h)
        planes_np, has_intra = self._prep_planes(f)
        p = planes_to_torch(planes_np, self.device)
        Yw, Uw, Vw, ry, ru, rv = _residual_and_inter(
            mb_w, mb_h, p, self.ref_y, self.ref_u, self.ref_v)
        if has_intra:
            Yw, Uw, Vw = _intra_scan(mb_w, mb_h, Yw, Uw, Vw, ry, ru, rv, p,
                                     diagonals(mb_w, mb_h))
        if self._needs_deblock(f, planes_np["nnz"]):
            Y, U, V = _deblock_crop(mb_w, mb_h, Yw, Uw, Vw, p)
        else:   # every edge has bS 0: the filter is an identity
            Y, U, V = _crop(mb_w, mb_h, Yw, Uw, Vw)
        damaged = (f.get("lost_slices", 0) > 0
                   or not bool(f["decoded"].all()))
        if damaged and not self._ec:
            raise RuntimeError(
                "slice parse error (%d lost slices, %d MBs undecoded)"
                % (f.get("lost_slices", 0),
                   int((f["decoded"] == 0).sum())))
        if damaged:
            # rare path: the shared reference-policy concealment on host
            self.concealed += 1
            prev = self._fetch_output(self.out_idx - 1, mb_w, mb_h)
            yuv = tuple(a.cpu().numpy() for a in (Y, U, V))
            Y, U, V = (torch.from_numpy(np.ascontiguousarray(a))
                       .to(self.device) for a in ref_np.conceal_undecoded(
                           f, yuv, prev, self.out_idx - 1, self._ec_mode))
        out = self._finish_frame(f, Y, U, V, damaged)
        if out is not None:
            yield out

    def _assign_slot(self, f):
        """Pick (and record) the ring slot for the frame about to be
        stored. Liveness-aware over the symbol layer's full post-marking
        DPB export (dpb_live): outputs absent from it (and not the
        EC-prev) can never be referenced again."""
        live = set(int(x) for x in (f.get("dpb_live") or []))
        live |= set(int(x) for x in (f.get("ref_list") or []))
        live.add(self.out_idx - 1)
        used = set(self.slot_of.values())
        slot = None
        if len(used) < self.MAX_REFS:
            slot = next(s for s in range(self.MAX_REFS) if s not in used)
        else:
            for oi in sorted(self.slot_of):
                if oi not in live:
                    slot = self.slot_of[oi]
                    break
            if slot is None:  # pathological: evict the oldest
                slot = self.slot_of[min(self.slot_of)]
        self.slot_of = {oi: sl for oi, sl in self.slot_of.items()
                        if sl != slot}
        self.slot_of[self.out_idx] = slot
        self.out_idx += 1
        return slot

    def _advance_output(self, f, damaged):
        """Per-frame output bookkeeping; True when the frame is visible.
        freeze-output: frames suppressed until the first complete
        error-free IDR decodes (reference decoder_core.cpp:164-167)."""
        if self._frozen and bool(f.get("is_idr")) and not damaged:
            self._frozen = False
        return not self._frozen

    def _finish_frame(self, f, Y, U, V, damaged):
        """Store the frame in the device ring, advance output state, and
        return the frame to yield (None while freeze-output holds)."""
        slot = self._assign_slot(f)
        _store_ref(self.ref_y, self.ref_u, self.ref_v, Y, U, V, slot)
        return (Y, U, V) if self._advance_output(f, damaged) else None

    def _prep_planes(self, f):
        """Host-side symbol-plane prep for one frame: returns
        (planes_np, has_intra). planes_np carries the keys of
        JaxDecoder._prep_planes (numpy, the symbol layer's dtypes)."""
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        # remap output-idx refs to ring slots
        rf = f["ref_frame"].astype(np.int32)
        slot_map = np.full(max(self.out_idx + 1, 1), -1, np.int32)
        for oi, sl in self.slot_of.items():
            slot_map[oi] = sl
        ref_slot = np.where(
            rf >= 0, slot_map[np.clip(rf, 0, len(slot_map) - 1)], -1) \
            .astype(np.int32)
        has_intra = bool(np.isin(f["mb_class"], [0, 1, 2]).any())
        planes = {
            "mb_class": f["mb_class"],
            "qp": f["qp"],
            "cbp_luma": f["cbp_luma"],
            "cbp_chroma": f["cbp_chroma"],
            "transform8": f["transform8"],
            "i16_mode": f["i16_mode"],
            "chroma_mode": f["chroma_mode"],
            "i4_modes": f["i4_modes"],
            "luma_ac": f["luma_ac"],
            "chroma_ac": f["chroma_ac"],
            "luma_dc": f["luma_dc"],
            "chroma_dc": f["chroma_dc"],
            "mv": f["mv"],
            "ref_slot": ref_slot,
            "ref_idx": f["ref_idx"],
            "slice_id": f["slice_id"],
            "deblock_idc": f["deblock_idc"],
            "alpha_off": f["alpha_off"],
            "beta_off": f["beta_off"],
            "avail": self._avail_plane(f),
            "use_scaling": np.bool_(bool(f["use_scaling"])),
            "chroma_qp_offset": np.int32(f["chroma_qp_offset"]),
            "second_chroma_qp_offset":
                np.int32(f["second_chroma_qp_offset"]),
            "w4": [ref_np.weights4(f["scaling4"][i]) for i in range(6)],
            "w8": [ref_np.weights8(f["scaling8"][i]) for i in range(2)],
            "nnz": self._nnz_plane(f),
        }
        # planes the frame does not use are omitted (transform-8x8, PCM,
        # weighted prediction), as JaxDecoder omits them
        if f["transform8"].any():
            planes["luma8"] = f["luma8"]
        if (f["mb_class"] == 8).any():
            planes["pcm"] = f["pcm"]
        wp = f["wp_luma"]
        has_wp = ((wp[:, :, 2] >= 0).any()
                  or (f["wp_cb"][:, :, 2] >= 0).any())
        if has_wp:
            planes["wp_luma"] = wp
            planes["wp_cb"] = f["wp_cb"]
            planes["wp_cr"] = f["wp_cr"]
            planes["wp_cmask"] = f["wp_cmask"]
        # bucketed dense-shift MC plan: frames the caps or WP exclude take
        # the general per-cell path via mc_fast=False
        plan = tmc.mc_fast_plan(mb_w, mb_h, ref_slot,
                                f["mv"].astype(np.int32), PAD)
        if has_wp:
            plan["mc_fast"] = np.bool_(False)
        plan["mc_any"] = np.bool_(bool((ref_slot >= 0).any()))
        planes.update(plan)
        return planes, has_intra

    def _fetch_output(self, out_idx, mb_w, mb_h):
        """Host copy of a stored output frame (concealment source), or
        None when it is not in the ring / has a different geometry."""
        slot = self.slot_of.get(out_idx)
        if slot is None:
            return None
        H, W = mb_h * 16, mb_w * 16
        cp = PAD // 2
        ry = self.ref_y[slot].cpu().numpy()
        if ry.shape != (H + 2 * PAD, W + 2 * PAD):
            return None
        return (ry[PAD:PAD + H, PAD:PAD + W],
                self.ref_u[slot].cpu().numpy()[cp:cp + H // 2,
                                               cp:cp + W // 2],
                self.ref_v[slot].cpu().numpy()[cp:cp + H // 2,
                                               cp:cp + W // 2])

    # the static helpers below are numpy, copied from JaxDecoder: their
    # module imports jax

    @staticmethod
    def _needs_deblock(f, nnz=None):
        """Host-side proof that EVERY edge in the frame has bS == 0, in
        which case the deblock wavefront is an identity and is skipped
        (all-skip P frames on static content). Conservative: any
        intra/PCM MB, any nonzero coefficient, any ref mismatch, or any
        adjacent-cell MV delta >= 4 quarter-pels keeps the filter on
        (8.7 bS derivation)."""
        if (f["deblock_idc"] == 1).all():
            return False
        cls = f["mb_class"]
        if np.isin(cls, [0, 1, 2, 8]).any():
            return True
        if nnz is not None:
            if nnz.any():
                return True
        elif (f["luma_ac"].any() or f["luma8"].any()
              or f["luma_dc"].any() or f["chroma_ac"].any()
              or f["chroma_dc"].any()):
            return True
        mb_w, mb_h = f["mb_w"], f["mb_h"]

        def grid(a):
            return a.reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3) \
                    .reshape(mb_h * 4, mb_w * 4).astype(np.int32)

        rg = grid(f["ref_idx"])
        if (np.diff(rg, axis=0) != 0).any() or \
                (np.diff(rg, axis=1) != 0).any():
            return True
        for comp in range(2):
            g = grid(f["mv"][:, :, comp])
            if (np.abs(np.diff(g, axis=0)) >= 4).any() or \
                    (np.abs(np.diff(g, axis=1)) >= 4).any():
                return True
        return False

    @staticmethod
    def _nnz_plane(f):
        n = f["mb_w"] * f["mb_h"]
        cls = f["mb_class"]
        t8 = (f["transform8"] != 0) & (cls != 1)
        cnt4 = np.count_nonzero(f["luma_ac"].reshape(n, 16, 16), axis=2)
        cnt8 = np.count_nonzero(f["luma8"].reshape(n, 4, 64), axis=2)
        blk = np.arange(16)
        b8_of = (blk // 4 // 2) * 2 + (blk % 4) // 2
        coded = ((f["cbp_luma"][:, None] >> b8_of[None, :]) & 1) != 0
        nnz4 = np.where(coded, cnt4, 0)
        # I16: count AC only (position 0 excluded already: luma_ac[...,0,0]
        # holds nothing for I16 — the export leaves scan pos 0 empty)
        nnz8 = np.zeros((n, 16), np.int32)
        for b8 in range(4):
            coded8 = ((f["cbp_luma"] >> b8) & 1).astype(bool)
            val = np.where(coded8, cnt8[:, b8], 0)
            by, bx = divmod(b8, 2)
            for sy in range(2):
                for sx in range(2):
                    nnz8[:, (by * 2 + sy) * 4 + bx * 2 + sx] = val
        out = np.where(t8[:, None], nnz8, nnz4)
        out[cls == 8] = 16
        return out

    @staticmethod
    def _avail_plane(f):
        """Vectorized L/T/TL/TR neighbour availability: same slice,
        in-bounds, and (under constrained_intra) intra neighbour."""
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        n = mb_w * mb_h
        sl = f["slice_id"].reshape(mb_h, mb_w)
        ci = bool(f["constrained_intra"])
        intra = np.isin(f["mb_class"], [0, 1, 2, 8]).reshape(mb_h, mb_w)

        def nbr(a, dy, dx, fill):
            out = np.full(a.shape, fill, a.dtype)
            ys0, ys1 = max(-dy, 0), mb_h - max(dy, 0)
            xs0, xs1 = max(-dx, 0), mb_w - max(dx, 0)
            out[ys0:ys1, xs0:xs1] = a[ys0 + dy:ys1 + dy, xs0 + dx:xs1 + dx]
            return out

        def ok(dy, dx):
            good = nbr(sl, dy, dx, np.int64(-1)) == sl
            if ci:
                good &= nbr(intra, dy, dx, False)
            return good

        out = np.stack([ok(0, -1), ok(-1, 0), ok(-1, -1), ok(-1, 1)],
                       axis=-1)
        return out.reshape(n, 4)
