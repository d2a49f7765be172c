"""H.264 frame reconstruction on PyTorch.

Port of losslessh264_tpu/decoder_jax.py's decode paths. Per frame:
residuals (dequant + IDCT, batched over the frame), inter prediction
(bucketed dense-shift MC over the K1 half-pel planes, or the general
per-cell gather), the intra wavefront (in plain torch one batched step
per slope-2 MB diagonal: the compact-carry scan over the full table, or
the plane-carrying scan over only the populated diagonals of a sparse
frame; on CUDA either is one launch of the K3 kernel, csrc/intra_dec.cu)
and the deblocking wavefront (the K2 kernel on CUDA). Runs of 3 to
INTRA_BATCH consecutive all-intra frames go through one wavefront
together (recon_intra_batch; one K3 launch on CUDA). The DPB ring
lives on the device.

Left out on purpose (TPU workarounds of JaxDecoder): the sparse
upload (_sparsify_run / _densify_planes / _unify_stack), the scanned
mixed runs (recon_run / _decode_scan_run: one XLA dispatch per run),
the padding of runs to 16 frames and of sparse diagonal tables to 16
rows (both bound JAX's compiled shapes), the coefficient-density rule
of JaxDecoder._batchable, and int8 narrowing of uploads.

Validated frame-exact against decoder_np.NpDecoder and the JAX stages
(tests/test_torch_decoder*.py).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from . import native
from . import ref_np
from . import trace
from .ops import deblock as tdb
from .ops import intra as tintra
from .ops import mc as tmc
from .ops import transform as tt
from .ops.wavefront import diagonals, scatter_tiles

PAD = 32          # reference-plane padding (luma)
WPAD = 8          # working-plane padding for wavefront gathers
BLK = tintra.BLK_ORDER

# static per-block above-right availability kind for I4x4 decode order
_I4_TR_KIND = tintra.I4_TR_KIND

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
    if trace.on():
        up = [t for v in out.values() if isinstance(v, (list, torch.Tensor))
              for t in (v if isinstance(v, list) else [v])]
        trace.count("dec.h2d_copies", len(up))
        trace.count_bytes("dec.h2d_bytes", *up)
    return out


def nnz_plane(f):
    """TorchDecoder._nnz_plane (the [n, 16] int64 plane) in compiled host
    code (csrc/plan_host.cpp, pip_plan_nnz). Reads the symbol layer's
    arrays in place: uint8 mb_class, transform8, cbp_luma [n], int16
    luma_ac [n, 16, 4, 4] and luma8 [n, 4, 8, 8]; another dtype, shape or
    layout raises."""
    n = f["mb_w"] * f["mb_h"]
    ha = _build.host_array
    out = np.empty((n, 16), np.int64)
    rc = _build.host_lib().pip_plan_nnz(
        ha(f["mb_class"], np.uint8, (n,), "nnz mb_class"),
        ha(f["transform8"], np.uint8, (n,), "nnz transform8"),
        ha(f["cbp_luma"], np.uint8, (n,), "nnz cbp_luma"),
        ha(f["luma_ac"], np.int16, (n, 16, 4, 4), "nnz luma_ac"),
        ha(f["luma8"], np.int16, (n, 4, 8, 8), "nnz luma8"), n,
        ctypes.c_void_p(out.ctypes.data))
    if rc != 0:
        raise ValueError(f"nnz plane: {n} MBs refused")
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


def _mc_cells(mb_w, mb_h, p, ref_y, ref_u, ref_v):
    """The per-cell route: on CUDA one launch of K11 (ops/mc.mc_cells),
    on the CPU _mc_legacy_cells' tiles as planes (K11 equals them on the
    inter cells and writes 0 on the others, which K7 never reads)."""
    if ref_y.device.type == "cuda":
        return tmc.mc_cells(ref_y, ref_u, ref_v, PAD, p, mb_w, mb_h)
    ty, tu, tv = _mc_legacy_cells(mb_w, mb_h, p, ref_y, ref_u, ref_v)
    return (_tiles_to_plane(ty, mb_w, mb_h, 16),
            _tiles_to_plane(tu, mb_w, mb_h, 8),
            _tiles_to_plane(tv, mb_w, mb_h, 8))


def _inter_pred(mb_w, mb_h, p, ref_y, ref_u, ref_v):
    """The frame's inter prediction planes ([H, W], [H/2, W/2], [H/2,
    W/2] int32): the bucketed dense-shift path (K1 and K6 on CUDA) when
    the host plan served the frame (mc_fast), the general per-cell path
    (K11 on CUDA) otherwise, WP frames always; None on a frame whose plan
    has no inter cell (mc_any False)."""
    if "mc_bucket" in p and not p["mc_any"]:
        return None
    if "mc_bucket" in p and p["mc_fast"]:
        trace.count("dec.mc_bucketed")
        trace.count("dec.mc_slots", int(p["mc_nslots"]))
        return tmc.mc_bucketed(ref_y, ref_u, ref_v, PAD, p, mb_w, mb_h)
    with trace.span("dec.inter.cells"):
        trace.count("dec.mc_cells")
        if "wp_luma" in p:
            trace.count("dec.mc_cells_wp")
        return _mc_cells(mb_w, mb_h, p, ref_y, ref_u, ref_v)


def _residual_and_inter(mb_w, mb_h, p, ref_y, ref_u, ref_v):
    """Inter prediction (_inter_pred), then the residuals of every MB and
    the reconstruction of the inter MBs (_residual_recon: one K7 launch on
    CUDA). Returns the WPAD-padded int32 working planes with inter MBs
    reconstructed (0 elsewhere) and the residual tiles."""
    pred = _inter_pred(mb_w, mb_h, p, ref_y, ref_u, ref_v)
    return _residual_recon(mb_w, mb_h, p, *(pred or (None,) * 3))


def _residual_recon(mb_w, mb_h, p, pred_y, pred_u, pred_v):
    """K7 wrapper: (Yw, Uw, Vw, res_y, res_u, res_v) of
    _residual_recon_plain (same arguments and results; pred_* None on a
    frame without prediction, read as 0). CPU tensors take the plain
    version; CUDA tensors one launch of csrc/residual_dec.cu."""
    if p["luma_ac"].device.type == "cpu":
        return _residual_recon_plain(mb_w, mb_h, p, pred_y, pred_u, pred_v)
    args, outs, _ = k7_operands(mb_w, mb_h, p, pred_y, pred_u, pred_v)
    rc = _build.lib().pip_residual_dec(*args,
                                       _build.stream(p["luma_ac"].device))
    _build.check(rc, "residual reconstruction")
    _build.count_launch(_residual_recon)
    return outs


_residual_recon.launches = 0

# the plane-dict entries K7 reads: (key, dtype, shape per MB); luma8 and
# pcm may be absent (frames without 8x8 transforms or PCM MBs)
K7_PLANES = (("mb_class", torch.uint8, ()), ("qp", torch.uint8, ()),
             ("cbp_luma", torch.uint8, ()), ("cbp_chroma", torch.uint8, ()),
             ("transform8", torch.uint8, ()),
             ("luma_ac", torch.int16, (16, 4, 4)),
             ("luma_dc", torch.int16, (4, 4)),
             ("luma8", torch.int16, (4, 8, 8)),
             ("chroma_ac", torch.int16, (8, 4, 4)),
             ("chroma_dc", torch.int16, (2, 2, 2)),
             ("ref_slot", torch.int32, (16,)), ("pcm", torch.uint8, (384,)))


def k7_operands(mb_w, mb_h, p, pred_y, pred_u, pred_v, host=False):
    """K7's operands on CUDA tensors, checked: the plane dict's buffers in
    the symbol layer's dtypes (K7_PLANES; a null pointer for an absent
    luma8 or pcm), the eight weight matrices (int32), use_scaling and the
    two chroma QP offsets, the prediction planes (int32, or null without
    prediction) and the fresh outputs; a buffer that does not start on 16
    bytes (the kernel moves 16-byte chunks) is copied first. Returns (the
    args of pip_residual_dec before the stream, (Yw, Uw, Vw, res_y, res_u,
    res_v), the tensors the args point into). host=True takes CPU tensors,
    for the kernel's CPU emulation (tools/cuda_emu.py)."""
    dev = p["luma_ac"].device
    if dev.type != "cuda" and not host:
        raise ValueError(f"residual kernel takes CUDA tensors, got {dev}")
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    P = ctypes.c_void_p
    keep, args = [], []

    def operand(t, dtype, shape, what):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"residual kernel {what}: {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, the kernel takes "
                             f"{shape} {dtype} on {dev}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        keep.append(t)
        return P(t.data_ptr())

    for key, dtype, shape in K7_PLANES:
        absent = key in ("luma8", "pcm") and key not in p
        args.append(None if absent else operand(p[key], dtype, (n,) + shape,
                                                key))
    args += [operand(w, torch.int32, (4, 4), "w4") for w in p["w4"]]
    args += [operand(w, torch.int32, (8, 8), "w8") for w in p["w8"]]
    if len(args) != len(K7_PLANES) + 8:
        raise ValueError("residual kernel takes 6 w4 and 2 w8 matrices")
    args += [int(bool(p["use_scaling"])), int(p["chroma_qp_offset"]),
             int(p["second_chroma_qp_offset"])]
    preds = (pred_y, pred_u, pred_v)
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    if pred_y is None:
        args += [None] * 3
    else:
        args += [operand(a, torch.int32, s, "prediction plane")
                 for a, s in zip(preds, shapes)]
    outs = tuple(torch.empty(s, dtype=torch.int32, device=dev) for s in (
        (H + 2 * WPAD, W + 2 * WPAD), (H // 2 + 2 * WPAD, W // 2 + 2 * WPAD),
        (H // 2 + 2 * WPAD, W // 2 + 2 * WPAD), (n, 16, 16), (n, 8, 8),
        (n, 8, 8)))
    args += [P(o.data_ptr()) for o in outs] + [mb_w, mb_h]
    return args, outs, keep


def _residual_recon_plain(mb_w, mb_h, p, pred_y, pred_u, pred_v):
    """Plain version of K7: the residuals of every MB (ops/transform
    luma_residuals, chroma_residuals), clip(pred + residual) on MBs whose
    16 ref_slot cells are all >= 0 (0 elsewhere; pred_* None reads as 0),
    the PCM overlay, and the placement into the WPAD-padded int32 working
    planes. Returns (Yw, Uw, Vw, res_y, res_u, res_v)."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    dev = p["luma_ac"].device
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
    if pred_y is None:
        pred_y = torch.zeros((H, W), dtype=torch.int32, device=dev)
        pred_u = torch.zeros((H // 2, W // 2), dtype=torch.int32, device=dev)
        pred_v = torch.zeros_like(pred_u)

    valid = p["ref_slot"].reshape(-1) >= 0
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


# the plane-dict entries the intra wavefronts read per MB
INTRA_KEYS = ("mb_class", "avail", "transform8", "i4_modes", "i16_mode",
              "chroma_mode")


def _intra_scan(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u, res_v, p, diags):
    """The intra pass over the full diagonal table `diags`: one K3 launch
    (ops/intra.intra_recon) for CUDA tensors, the plain compact-carry
    wavefront (_intra_scan_plain) for CPU tensors. Takes a leading frame
    axis as _intra_scan_plain does."""
    if Yw.device.type == "cuda":
        return tintra.intra_recon(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u,
                                  res_v, p)
    return _intra_scan_plain(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u, res_v, p,
                             diags)


def _intra_scan_plain(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u, res_v, p,
                      diags):
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

    With a leading frame axis on the planes ([B, ...]: Yw/Uw/Vw, res_*
    [B, n, t, t] and p's INTRA_KEYS planes [B, n, ...]; recon_intra_batch)
    every step runs the B frames' lanes of its diagonal at once, each
    frame on its own buffers: JAX's vmap folded into the lane axis.
    Returns the planes with every intra MB reconstructed."""
    batched = Yw.dim() == 3
    if not batched:
        Yw, Uw, Vw, res_y, res_u, res_v = (
            a[None] for a in (Yw, Uw, Vw, res_y, res_u, res_v))
        p = {k: p[k][None] for k in INTRA_KEYS}
    B = Yw.shape[0]
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    dev = Yw.device
    i32 = torch.int32
    cls = p["mb_class"].to(i32).reshape(B * n)
    avail = p["avail"].reshape(B * n, 4)  # bool: L, T, TL, TR
    t8 = p["transform8"].to(i32).reshape(B * n)
    i4m = p["i4_modes"].to(i32).reshape(B * n, 16)
    i16m = p["i16_mode"].to(i32).reshape(B * n)
    cmode = p["chroma_mode"].to(i32).reshape(B * n)
    res_y = res_y.reshape(B * n, 16, 16)
    res_u = res_u.reshape(B * n, 8, 8)
    res_v = res_v.reshape(B * n, 8, 8)
    is_intra = (cls == 0) | (cls == 1) | (cls == 2)

    def tiles_of(plane, t):
        """[B, Hw, Ww] working planes -> [B*n, t, t] MB tiles."""
        h, w = mb_h * t, mb_w * t
        return plane[:, WPAD:WPAD + h, WPAD:WPAD + w] \
            .reshape(B, mb_h, t, mb_w, t).permute(0, 1, 3, 2, 4) \
            .reshape(B * n, t, t)

    in_y, in_u, in_v = tiles_of(Yw, 16), tiles_of(Uw, 8), tiles_of(Vw, 8)

    # carried context buffers, one row per frame (+pad so column -1 / TR
    # overhang reads land on zeros — matching the zero WPAD border of
    # the plane form), each with one trailing scratch element for
    # dead-lane writes
    PADL, PADR = 1, 8
    LY, LC = W + PADL + PADR, W // 2 + PADL + PADR

    def z(*shape):
        return torch.zeros(shape, dtype=i32, device=dev)

    top = {"y": z(B, LY + 1), "u": z(B, LC + 1), "v": z(B, LC + 1)}
    left = {"y": z(B, mb_h + 1, 16), "u": z(B, mb_h + 1, 8),
            "v": z(B, mb_h + 1, 8)}
    tlb = {"y": z(B, mb_w + 2), "u": z(B, mb_w + 2), "v": z(B, mb_w + 2)}
    o25 = torch.arange(25, device=dev)
    o9 = torch.arange(9, device=dev)
    o16 = torch.arange(16, device=dev)
    o8 = torch.arange(8, device=dev)

    # lanes: each diagonal's K MBs once per frame; fb = a lane's frame
    diags_t = torch.tensor(diags, device=dev).long().repeat(1, B)
    K = diags_t.shape[1]
    fb = torch.arange(B, device=dev).repeat_interleave(K // B)

    def scat(buf, cols, vals, m, length):
        idx = cols[:, None] + (o16 if m == 16 else o8)[None, :]
        idx = torch.where(idx < length, idx, length)   # past the end: drop
        buf[fb[:, None].expand_as(idx), idx] = vals

    Ty, Tu, Tv = [], [], []
    for d in range(diags_t.shape[0]):
        mb_list = diags_t[d]
        mb_c = torch.clamp(mb_list, 0, n - 1)
        mby = mb_c // mb_w
        mbx = mb_c % mb_w
        g = fb * n + mb_c   # the lane's MB in the [B*n] planes

        # each lane's [17,25] luma / [9,9] chroma context from the
        # compact buffers (row 0 = top incl. TL corner + TR overhang,
        # col 0 = left), interior seeded with the input tile
        loc = z(K, 17, 25)
        loc[:, 0, :] = top["y"][fb[:, None], (mbx * 16 + PADL - 1)[:, None]
                                + o25]
        loc[:, 0, 0] = tlb["y"][fb, mbx]
        loc[:, 1:, 0] = left["y"][fb, mby]
        loc[:, 1:, 1:17] = in_y[g]
        locc = {}
        for c, inp in (("u", in_u), ("v", in_v)):
            lc = z(K, 9, 9)
            lc[:, 0, :] = top[c][fb[:, None], (mbx * 8 + PADL - 1)[:, None]
                                 + o9]
            lc[:, 0, 0] = tlb[c][fb, mbx]
            lc[:, 1:, 0] = left[c][fb, mby]
            lc[:, 1:, 1:] = inp[g]
            locc[c] = lc

        av = avail[g]
        cl = cls[g]
        tiles = _recon_mb_luma(loc, res_y[g], cl, i4m[g], i16m[g], t8[g],
                               av[:, 0], av[:, 1], av[:, 2], av[:, 3])
        tus = _recon_mb_chroma(locc["u"], res_u[g], cl, cmode[g],
                               av[:, 0], av[:, 1])
        tvs = _recon_mb_chroma(locc["v"], res_v[g], cl, cmode[g],
                               av[:, 0], av[:, 1])
        live = mb_list >= 0
        do = (live & is_intra[g])[:, None, None]
        tiles = torch.where(do, tiles, in_y[g])
        tus = torch.where(do, tus, in_u[g])
        tvs = torch.where(do, tvs, in_v[g])

        # buffer updates from the FINAL tiles. Order inside one step:
        # the reads above used the OLD buffers; save the above-left
        # corners the NEXT diagonal's right neighbours need BEFORE this
        # step's top rows overwrite them
        tidx = torch.where(live, mbx + 1, mb_w + 1)
        tlb["y"][fb, tidx] = top["y"][fb, torch.clamp(
            mbx * 16 + 16 + PADL - 1, 0, LY - 1)]
        for c in ("u", "v"):
            tlb[c][fb, tidx] = top[c][fb, torch.clamp(
                mbx * 8 + 8 + PADL - 1, 0, LC - 1)]
        scat(top["y"], torch.where(live, mbx * 16 + PADL, W + PADL),
             tiles[:, 15, :], 16, LY)
        ccol = torch.where(live, mbx * 8 + PADL, W // 2 + PADL)
        scat(top["u"], ccol, tus[:, 7, :], 8, LC)
        scat(top["v"], ccol, tvs[:, 7, :], 8, LC)
        # dead lanes target the scratch row, never a clamped live one
        lrow = torch.where(live, mby, mb_h)
        left["y"][fb, lrow] = tiles[:, :, 15]
        left["u"][fb, lrow] = tus[:, :, 7]
        left["v"][fb, lrow] = tvs[:, :, 7]
        Ty.append(tiles)
        Tu.append(tus)
        Tv.append(tvs)

    # reassembly: every diagonal lane's tile back to its MB slot (dead
    # lanes land in scratch slot B*n)
    flat_mb = diags_t.reshape(-1)
    ok = flat_mb >= 0
    tgt = torch.where(ok, fb.repeat(diags_t.shape[0]) * n
                      + torch.clamp(flat_mb, 0, n - 1), B * n)

    def put(base, T, t):
        out = z(B * n + 1, t, t)
        out[tgt] = torch.cat(T)
        covered = torch.zeros(B * n + 1, dtype=torch.bool, device=dev)
        covered[tgt] = ok
        return torch.where(covered[:B * n, None, None], out[:B * n], base) \
            .reshape(B, mb_h, mb_w, t, t).permute(0, 1, 3, 2, 4) \
            .reshape(B, mb_h * t, mb_w * t)

    Yw, Uw, Vw = Yw.clone(), Uw.clone(), Vw.clone()
    Yw[:, WPAD:WPAD + H, WPAD:WPAD + W] = put(in_y, Ty, 16)
    Uw[:, WPAD:WPAD + H // 2, WPAD:WPAD + W // 2] = put(in_u, Tu, 8)
    Vw[:, WPAD:WPAD + H // 2, WPAD:WPAD + W // 2] = put(in_v, Tv, 8)
    if not batched:
        return Yw[0], Uw[0], Vw[0]
    return Yw, Uw, Vw


def _gather_wins(plane, y0s, x0s, rows, cols):
    """[K] window corners -> [K, rows, cols] windows of `plane`, by one
    flat gather."""
    Wp = plane.shape[1]
    r = torch.arange(rows, device=plane.device)
    c = torch.arange(cols, device=plane.device)
    idx = ((y0s[:, None, None] + r[None, :, None]) * Wp
           + x0s[:, None, None] + c[None, None, :])
    return plane.reshape(-1)[idx]


def _intra_scan_sparse(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u, res_v, p,
                       diags):
    """The intra pass over the populated diagonals `diags` of a sparse
    frame: one K3 launch for CUDA tensors (the kernel runs every intra MB
    of the frame, which are exactly the MBs of those diagonals), the
    plain plane-carrying wavefront (_intra_scan_sparse_plain) for CPU
    tensors."""
    if Yw.device.type == "cuda":
        return tintra.intra_recon(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u,
                                  res_v, p)
    return _intra_scan_sparse_plain(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u,
                                    res_v, p, diags)


def _intra_scan_sparse_plain(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u, res_v,
                             p, diags):
    """Plane-carrying intra wavefront over a SUBSET of the diagonals
    (numpy [r, K], -1 padding; TorchDecoder._intra_diags lists exactly
    the populated ones, so the steps skip diagonals without an intra
    MB). The compact-carry _intra_scan is only correct over the full
    contiguous table: its top/left/tl buffers are fed by every MB it
    processes, so a skipped diagonal (the inter neighbours of a sparse
    intra MB, e.g. FMO-dispersed P frames, SVA_FM1_E) would leave zeros
    where neighbour pixels belong. Here each lane gathers its [17,25] /
    [9,9] context straight from the working planes, which already hold
    the inter recon and every earlier diagonal's intra recon, and
    writes its tiles back into them (ops/wavefront.scatter_tiles)."""
    n = mb_w * mb_h
    dev = Yw.device
    cls = p["mb_class"].to(torch.int32)
    avail = p["avail"]  # [n,4] bool: L, T, TL, TR
    is_intra = (cls == 0) | (cls == 1) | (cls == 2)
    i4m = p["i4_modes"].to(torch.int32)
    i16m = p["i16_mode"].to(torch.int32)
    t8 = p["transform8"].to(torch.int32)
    cmode = p["chroma_mode"].to(torch.int32)
    for mb_list in torch.tensor(diags, device=dev).long():
        mb_c = torch.clamp(mb_list, 0, n - 1)
        y0s = (mb_c // mb_w) * 16 + WPAD
        x0s = (mb_c % mb_w) * 16 + WPAD
        cys = (mb_c // mb_w) * 8 + WPAD
        cxs = (mb_c % mb_w) * 8 + WPAD
        loc = _gather_wins(Yw, y0s - 1, x0s - 1, 17, 25)
        locu = _gather_wins(Uw, cys - 1, cxs - 1, 9, 9)
        locv = _gather_wins(Vw, cys - 1, cxs - 1, 9, 9)
        av = avail[mb_c]
        cl = cls[mb_c]
        tiles = _recon_mb_luma(loc, res_y[mb_c], cl, i4m[mb_c], i16m[mb_c],
                               t8[mb_c], av[:, 0], av[:, 1], av[:, 2],
                               av[:, 3])
        tus = _recon_mb_chroma(locu, res_u[mb_c], cl, cmode[mb_c], av[:, 0],
                               av[:, 1])
        tvs = _recon_mb_chroma(locv, res_v[mb_c], cl, cmode[mb_c], av[:, 0],
                               av[:, 1])
        do = (mb_list >= 0) & is_intra[mb_c]
        Yw = scatter_tiles(Yw, tiles, y0s, x0s, do)
        Uw = scatter_tiles(Uw, tus, cys, cxs, do)
        Vw = scatter_tiles(Vw, tvs, cys, cxs, do)
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
    with trace.span("dec.deblock.params"):
        params = tdb.edge_params(
            mb_w, mb_h, p["mb_class"], p["qp"], p["nnz"], p["mv"],
            p["ref_idx"], p["slice_id"], p["deblock_idc"], p["alpha_off"],
            p["beta_off"], p["transform8"], p["chroma_qp_offset"])
    with trace.span("dec.deblock.filter"):
        Yw, Uw, Vw = tdb.deblock_planes(mb_w, mb_h, Yw, Uw, Vw, params)
    with trace.span("dec.deblock.crop"):
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


def recon_intra_batch(mb_w, mb_h, planes_b, ref_y, ref_u, ref_v, diags,
                      deblocks):
    """B consecutive ALL-INTRA frames through ONE intra wavefront: intra
    frames read no reference, so every diagonal step carries the B
    frames' lanes together and the per-step cost that bounds
    single-frame intra decode (the host launching ~900 small ops) is
    paid once for the run. planes_b: the frames' plane dicts
    (planes_to_torch); deblocks: per frame, whether any edge filters
    (TorchDecoder._needs_deblock). Residuals per frame (no MC: the rings
    are not read), the batched intra pass (_intra_scan: one K3 launch
    over the B frames on CUDA, the compact-carry wavefront over the full
    table on the CPU), then the deblock per frame (K2, one launch each)
    and the crop. Returns the [B, H, W] / [B, H/2, W/2] uint8 planes."""
    with trace.span("dec.residual"):
        work = [_residual_and_inter(mb_w, mb_h, p, ref_y, ref_u, ref_v)
                for p in planes_b]
    with trace.span("dec.intra"):
        Yw, Uw, Vw, ry, ru, rv = (torch.stack(a) for a in zip(*work))
        pb = {k: torch.stack([p[k] for p in planes_b]) for k in INTRA_KEYS}
        Yw, Uw, Vw = _intra_scan(mb_w, mb_h, Yw, Uw, Vw, ry, ru, rv, pb,
                                 diags)
    out = []
    with trace.span("dec.deblock"):
        for k, (p, db) in enumerate(zip(planes_b, deblocks)):
            if db:
                out.append(_deblock_crop(mb_w, mb_h, Yw[k], Uw[k], Vw[k], p))
            else:
                out.append(_crop(mb_w, mb_h, Yw[k], Uw[k], Vw[k]))
        return tuple(torch.stack(a) for a in zip(*out))


def _store_refs_k(ref_y, ref_u, ref_v, Yk, Uk, Vk, slots):
    """Store a run's B frames ([B, ...] planes) into ring slots `slots`,
    edge-padded, with one indexed write per plane (in place). A later
    frame of the run wins a slot that two of them share, as stores in
    decode order would give."""
    last = {int(s): k for k, s in enumerate(slots)}
    dev = ref_y.device
    ks = torch.tensor(list(last.values()), device=dev)
    ss = torch.tensor(list(last), device=dev)
    ref_y[ss] = _edge_pad(Yk[ks], PAD)
    ref_u[ss] = _edge_pad(Uk[ks], PAD // 2)
    ref_v[ss] = _edge_pad(Vk[ks], PAD // 2)


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
        with trace.span("dec.open"):
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
        # the intra route of every decoded frame, in decode order:
        # ("batch", B), ("sparse", rows), ("full", rows) or ("none", 0)
        self.routes = []

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

    INTRA_BATCH = 16  # frames per all-intra run (recon_intra_batch)

    @staticmethod
    def _intra_sel(mb_w, mb_h, intra_mask):
        """The intra-pass plan of a frame, as JaxDecoder._intra_sel:
        (kind, sel) with kind 0 = no intra MB, 1 = very sparse (<= 4
        populated diagonals), 2 = sparse (<= 16), both listed in sel
        [16, K] (-1 rows after them), 3 = dense (more than 16 populated
        diagonals, or a table of at most 16: the full table)."""
        diags = diagonals(mb_w, mb_h)
        sel = np.full((16, diags.shape[1]), -1, np.int32)
        has = intra_mask[np.maximum(diags, 0)] & (diags >= 0)
        rows = np.flatnonzero(has.any(axis=1))
        if len(rows) == 0:
            return 0, sel
        if len(rows) > 16 or diags.shape[0] <= 16:
            return 3, sel
        sel[:len(rows)] = diags[rows]
        return 1 if len(rows) <= 4 else 2, sel

    @staticmethod
    def _intra_diags(mb_w, mb_h, intra_mask):
        """(diags or None, is_full), as JaxDecoder._intra_diags: None
        without intra MBs; the full table (is_full) for kind 3 of
        _intra_sel; else exactly the populated diagonals, without the
        -1 rows that JAX pads in to bound its compiled shapes (each
        would cost a step of host launches here)."""
        kind, sel = TorchDecoder._intra_sel(mb_w, mb_h, intra_mask)
        if kind == 0:
            return None, False
        if kind == 3:
            return diagonals(mb_w, mb_h), True
        return sel[:int((sel[:, 0] >= 0).sum())], False

    def frames(self):
        it = iter(self.sym)
        buf = []   # pending all-intra run (one geometry, undamaged)
        while True:
            try:
                fid = trace.new_frame()
                with trace.span("dec.symbols", frame=fid):
                    f = next(it)
                f["trace_frame"] = fid
            except StopIteration:
                yield from self._flush_run(buf)
                return
            except RuntimeError:
                yield from self._flush_run(buf)
                # unrecoverable symbol-layer error mid-stream: repeat the
                # last output once and end (NpDecoder contract)
                if not self._ec or self.out_idx == 0:
                    raise
                self.concealed += 1
                prev = self.slot_of.get(self.out_idx - 1)
                if prev is None or self._frozen:
                    return
                cp = PAD // 2
                trace.count("dec.frames")
                yield (self.ref_y[prev][PAD:-PAD, PAD:-PAD],
                       self.ref_u[prev][cp:-cp, cp:-cp],
                       self.ref_v[prev][cp:-cp, cp:-cp])
                return
            if self._batchable(f):
                if buf and (buf[0]["mb_w"], buf[0]["mb_h"]) != \
                        (f["mb_w"], f["mb_h"]):
                    yield from self._flush_run(buf)
                    buf = []
                buf.append(f)
                if len(buf) == self.INTRA_BATCH:
                    yield from self._decode_intra_batch(buf)
                    buf = []
                continue
            yield from self._flush_run(buf)
            buf = []
            yield from self._decode_one(f)

    @staticmethod
    def _batchable(f):
        """Undamaged all-intra frames (MB classes I4x4/I16x16/I8x8/PCM:
        JaxDecoder._decode_run's test) join a run. JaxDecoder._batchable
        also admits coefficient-sparse P frames into scanned mixed runs
        (recon_run), which the port leaves out."""
        return (f.get("lost_slices", 0) == 0 and bool(f["decoded"].all())
                and bool(np.isin(f["mb_class"], [0, 1, 2, 8]).all()))

    def _flush_run(self, buf):
        """Drain a pending run: 3 or more frames in one batch (JaxDecoder
        pads such a run to INTRA_BATCH and scans it, to reuse one
        compiled shape; eager torch needs neither), shorter ones per
        frame (JAX's threshold)."""
        if len(buf) >= 3:
            yield from self._decode_intra_batch(buf)
            return
        for f in buf:
            yield from self._decode_one(f)

    def _decode_intra_batch(self, fs):
        """A run of all-intra frames: slots for the whole run assigned
        first (each frame's prep sees the run's earlier assignments, as
        in decode order), one recon_intra_batch, one _store_refs_k, then
        the frames in order under freeze-output."""
        mb_w, mb_h = fs[0]["mb_w"], fs[0]["mb_h"]
        with trace.span("dec.frame", frame=fs[0]["trace_frame"]):
            with trace.span("dec.plan"), trace.span("dec.plan.refs"):
                self._prep_refs(mb_w, mb_h)
            preps, deblocks, slots = [], [], []
            for f in fs:
                with trace.span("dec.plan", frame=f["trace_frame"]):
                    planes_np = self._prep_planes(f)[0]
                    with trace.span("dec.plan.deblock"):
                        deblocks.append(self._needs_deblock(
                            f, planes_np["nnz"]))
                    with trace.span("dec.plan.slots"):
                        slots.append(self._assign_slot(f))
                with trace.span("dec.upload", frame=f["trace_frame"]):
                    preps.append(planes_to_torch(planes_np, self.device))
            Yb, Ub, Vb = recon_intra_batch(mb_w, mb_h, preps, self.ref_y,
                                           self.ref_u, self.ref_v,
                                           diagonals(mb_w, mb_h), deblocks)
            with trace.span("dec.store"):
                _store_refs_k(self.ref_y, self.ref_u, self.ref_v, Yb, Ub, Vb,
                              slots)
        self.routes += [("batch", len(fs))] * len(fs)
        for k, f in enumerate(fs):
            self.crop_px = f.get("crop_px", (0, 0, 0, 0))
            if self._advance_output(f, damaged=False):
                trace.count("dec.frames")
                yield Yb[k], Ub[k], Vb[k]

    def _decode_one(self, f):
        with trace.span("dec.frame", frame=f.get("trace_frame")):
            out = self._decode_frame(f)
        if out is not None:
            trace.count("dec.frames")
            yield out

    def _decode_frame(self, f):
        """One frame through every stage: the frame to yield, or None."""
        self.crop_px = f.get("crop_px", (0, 0, 0, 0))
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        with trace.span("dec.plan"):
            with trace.span("dec.plan.refs"):
                self._prep_refs(mb_w, mb_h)
            planes_np, diags, has_intra, full_intra = self._prep_planes(f)
        with trace.span("dec.upload"):
            p = planes_to_torch(planes_np, self.device)
        with trace.span("dec.inter"):
            pred = _inter_pred(mb_w, mb_h, p, self.ref_y, self.ref_u,
                               self.ref_v)
        with trace.span("dec.residual"):
            Yw, Uw, Vw, ry, ru, rv = _residual_recon(
                mb_w, mb_h, p, *(pred or (None,) * 3))
        with trace.span("dec.intra"):
            if has_intra:
                # the full table -> compact carry; a subset of the
                # diagonals -> plane carrying (skipped diagonals would
                # starve the compact buffers)
                scan = _intra_scan if full_intra else _intra_scan_sparse
                Yw, Uw, Vw = scan(mb_w, mb_h, Yw, Uw, Vw, ry, ru, rv, p,
                                  diags)
                self.routes.append(("full" if full_intra else "sparse",
                                    len(diags)))
            else:
                self.routes.append(("none", 0))
        with trace.span("dec.deblock"):
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
            with trace.span("dec.conceal"):
                self.concealed += 1
                prev = self._fetch_output(self.out_idx - 1, mb_w, mb_h)
                yuv = tuple(a.cpu().numpy() for a in (Y, U, V))
                Y, U, V = (torch.from_numpy(np.ascontiguousarray(a))
                           .to(self.device)
                           for a in ref_np.conceal_undecoded(
                               f, yuv, prev, self.out_idx - 1,
                               self._ec_mode))
        with trace.span("dec.store"):
            return self._finish_frame(f, Y, U, V, damaged)

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
        (planes_np, diags, has_intra, full_intra) as
        JaxDecoder._prep_planes does: planes_np carries its keys (numpy,
        the symbol layer's dtypes), diags the intra pass's table
        (_intra_diags; None without intra MBs)."""
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        with trace.span("dec.plan.slots"):
            # remap output-idx refs to ring slots
            rf = f["ref_frame"].astype(np.int32)
            slot_map = np.full(max(self.out_idx + 1, 1), -1, np.int32)
            for oi, sl in self.slot_of.items():
                slot_map[oi] = sl
            ref_slot = np.where(
                rf >= 0, slot_map[np.clip(rf, 0, len(slot_map) - 1)], -1) \
                .astype(np.int32)
        with trace.span("dec.plan.intra"):
            diags, full_intra = self._intra_diags(
                mb_w, mb_h, np.isin(f["mb_class"], [0, 1, 2]))
        with trace.span("dec.plan.avail"):
            avail = self._avail_plane(f)
        with trace.span("dec.plan.scaling"):
            w4 = [ref_np.weights4(f["scaling4"][i]) for i in range(6)]
            w8 = [ref_np.weights8(f["scaling8"][i]) for i in range(2)]
        with trace.span("dec.plan.nnz"):
            nnz = nnz_plane(f)
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
            "avail": avail,
            "use_scaling": np.bool_(bool(f["use_scaling"])),
            "chroma_qp_offset": np.int32(f["chroma_qp_offset"]),
            "second_chroma_qp_offset":
                np.int32(f["second_chroma_qp_offset"]),
            "w4": w4,
            "w8": w8,
            "nnz": nnz,
        }
        # planes the frame does not use are omitted (transform-8x8, PCM,
        # weighted prediction), as JaxDecoder omits them
        if f["transform8"].any():
            planes["luma8"] = f["luma8"]
        if (f["mb_class"] == 8).any():
            planes["pcm"] = f["pcm"]
        with trace.span("dec.plan.mc"):
            wp = f["wp_luma"]
            has_wp = ((wp[:, :, 2] >= 0).any()
                      or (f["wp_cb"][:, :, 2] >= 0).any())
            if has_wp:
                planes["wp_luma"] = wp
                planes["wp_cb"] = f["wp_cb"]
                planes["wp_cr"] = f["wp_cr"]
                planes["wp_cmask"] = f["wp_cmask"]
            # bucketed dense-shift MC plan: frames the caps or WP exclude
            # take the general per-cell path via mc_fast=False
            plan, spilled = tmc.mc_plan(mb_w, mb_h, ref_slot, f["mv"], PAD)
            if has_wp:
                plan["mc_fast"] = np.bool_(False)
            n_inter = int(np.count_nonzero(ref_slot >= 0))
            plan["mc_any"] = np.bool_(n_inter > 0)
            planes.update(plan)
            if n_inter and not plan["mc_fast"]:
                trace.count("dec.mc_cells_n", n_inter)
        if spilled:
            trace.count("dec.mc_spilled")
        return planes, diags, diags is not None, full_intra

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
    def _needs_deblock(f, nnz):
        """Host-side proof that EVERY edge in the frame has bS == 0, in
        which case the deblock wavefront is an identity and is skipped
        (all-skip P frames on static content). Conservative: any
        intra/PCM MB, any nonzero luma block (nnz: the frame's [n, 16]
        plane, _nnz_plane / nnz_plane), any ref mismatch, or any
        adjacent-cell MV delta >= 4 quarter-pels keeps the filter on
        (8.7 bS derivation)."""
        if (f["deblock_idc"] == 1).all():
            return False
        cls = f["mb_class"]
        if np.isin(cls, [0, 1, 2, 8]).any():
            return True
        if nnz.any():
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
        """The plain version of nnz_plane, which the decode calls."""
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
