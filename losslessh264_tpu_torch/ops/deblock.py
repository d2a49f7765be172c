"""In-loop deblocking (torch) and the K2 kernel wrapper.

Port of losslessh264_tpu/ops/deblock.py. Boundary strengths and filter
thresholds are computed batched over every edge of the frame. The
filtering of an MB reads pixels its left, above-left, above and
above-right neighbours may have modified (reference: the serial per-MB
loop WelsDeblockingFilterSlice / WelsDeblockingMb, deblocking.cpp
:815-872), so MBs run in an order that respects those four
dependencies; every such order gives the same planes.

`deblock_frame` takes the plain version (`deblock_wavefront_plain`, a
Python loop over the slope-2 MB diagonals, each step batched over the
diagonal's MBs) for CPU tensors, and the hand-written CUDA kernel
csrc/deblock.cu (`deblock_wavefront`, one persistent launch per frame
that walks MB rows, replacing the Pallas kernel of
losslessh264_tpu/ops/deblock_pallas.py:199) for CUDA tensors.
Element-exact vs decoder_np._deblock.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..ref_np import ALPHA_TABLE as ALPHA
from ..ref_np import BETA_TABLE as BETA
from ..ref_np import CHROMA_QP
from ..ref_np import TC0_TABLE as TC0
from .consts import on
from .wavefront import diagonals, scatter_tiles

WPAD = 8  # working-plane margin the padded planes must carry
TC0_FLAT = TC0.reshape(-1).copy()
# the interior edges (1 and 3) that a transform-8x8 MB does not filter
_T8_OFF = np.array([False, True, False, True])


# ---------------------------------------------------------------------------
# batched boundary strengths
# ---------------------------------------------------------------------------
def compute_bs(mb_w, mb_h, mb_class, nnz, mv, ref, slice_id, deblock_idc):
    """Returns (bs_v [n,4,16], bs_h [n,4,16]) int32 boundary strengths.

    nnz: [n,16] per-cell nonzero flags/counts; mv [n,16,2]; ref [n,16].
    Edges whose filtering is disabled get bS 0. Formulated on full-frame
    4x4-cell grids where every neighbour access is a roll.
    """
    dev = mb_class.device
    intra = ((mb_class == 0) | (mb_class == 1) | (mb_class == 2)
             | (mb_class == 8))
    ch, cw = 4 * mb_h, 4 * mb_w

    def cellgrid(a):  # [n, 16, ...] -> [ch, cw, ...]
        rest = tuple(a.shape[2:])
        return (a.reshape((mb_h, mb_w, 4, 4) + rest)
                .permute((0, 2, 1, 3) + tuple(range(4, 4 + len(rest))))
                .reshape((ch, cw) + rest))

    def mbgrid(a):    # [n] per-MB -> [ch, cw] per-cell
        return a.reshape(mb_h, mb_w).repeat_interleave(4, 0) \
            .repeat_interleave(4, 1)

    nzg = cellgrid((nnz > 0).to(torch.int32))
    refg = cellgrid(ref.to(torch.int32))
    mvg = cellgrid(mv.to(torch.int32))
    intrag = mbgrid(intra)
    sliceg = mbgrid(slice_id.to(torch.int32))
    idcg = mbgrid(deblock_idc.to(torch.int32))
    colg = torch.arange(cw, device=dev)[None, :].expand(ch, cw)
    rowg = torch.arange(ch, device=dev)[:, None].expand(ch, cw)

    def bs_dir(axis):
        """bs of each cell's left (axis=1) / top (axis=0) edge."""
        def shp(g):
            return torch.roll(g, 1, axis)
        pos = colg if axis == 1 else rowg
        mb_edge = (pos % 4) == 0
        nzp, rp, mvp = shp(nzg), shp(refg), shp(mvg)
        mv_far = ((torch.abs(mvp[..., 0] - mvg[..., 0]) >= 4)
                  | (torch.abs(mvp[..., 1] - mvg[..., 1]) >= 4))
        b = torch.where((nzp | nzg) > 0, 2,
                        torch.where((rp != refg) | mv_far, 1, 0))
        b = torch.where(shp(intrag) | intrag,
                        torch.where(mb_edge, 4, 3), b)
        cross = shp(sliceg) != sliceg
        off = ((idcg == 1)
               | (mb_edge & ((pos == 0) | ((idcg == 2) & cross))))
        return torch.where(off, 0, b).to(torch.int32)

    def per_mb(bsg, axis):
        """[ch, cw] cell-edge grid -> [n, 4 edges, 16 sample lines]."""
        a = bsg.reshape(mb_h, 4, mb_w, 4)
        if axis == 1:   # vertical: edge = cell col, line = sample row
            a = a.permute(0, 2, 3, 1)
        else:           # horizontal: edge = cell row, line = sample col
            a = a.permute(0, 2, 1, 3)
        return a.reshape(mb_h * mb_w, 4, 4).repeat_interleave(4, dim=2)

    return per_mb(bs_dir(1), 1), per_mb(bs_dir(0), 0)


# ---------------------------------------------------------------------------
# edge filters (vectorized along the edge)
# ---------------------------------------------------------------------------
def filter_luma(p, q, bs, alpha, beta, tc0):
    """p,q: [4,...] int32 (p[0] nearest). Returns filtered (p0..p2, q0..q2)."""
    W_ = torch.where
    p0, p1, p2, p3 = p[0], p[1], p[2], p[3]
    q0, q1, q2, q3 = q[0], q[1], q[2], q[3]
    filt = ((bs > 0) & (torch.abs(p0 - q0) < alpha)
            & (torch.abs(p1 - p0) < beta) & (torch.abs(q1 - q0) < beta))
    strong = filt & (bs == 4)
    normal = filt & (bs < 4)
    ap = torch.abs(p2 - p0)
    aq = torch.abs(q2 - q0)
    tc = tc0 + (ap < beta).to(torch.int32) + (aq < beta).to(torch.int32)
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = W_(normal, torch.clamp(p0 + delta, 0, 255), p0)
    nq0 = W_(normal, torch.clamp(q0 - delta, 0, 255), q0)
    dp1 = torch.clamp((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1,
                      -tc0, tc0)
    np1 = W_(normal & (ap < beta), p1 + dp1, p1)
    dq1 = torch.clamp((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1,
                      -tc0, tc0)
    nq1 = W_(normal & (aq < beta), q1 + dq1, q1)
    cond = torch.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp = cond & (ap < beta)
    sq = cond & (aq < beta)
    np0 = W_(strong & sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
             W_(strong & ~sp, (2 * p1 + p0 + q1 + 2) >> 2, np0))
    np1 = W_(strong & sp, (p2 + p1 + p0 + q0 + 2) >> 2, np1)
    np2 = W_(strong & sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    nq0 = W_(strong & sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
             W_(strong & ~sq, (2 * q1 + q0 + p1 + 2) >> 2, nq0))
    nq1 = W_(strong & sq, (q2 + q1 + q0 + p0 + 2) >> 2, nq1)
    nq2 = W_(strong & sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    return (np0, np1, np2), (nq0, nq1, nq2)


def filter_chroma(p, q, bs, alpha, beta, tc0):
    W_ = torch.where
    p0, p1 = p[0], p[1]
    q0, q1 = q[0], q[1]
    filt = ((bs > 0) & (torch.abs(p0 - q0) < alpha)
            & (torch.abs(p1 - p0) < beta) & (torch.abs(q1 - q0) < beta))
    strong = filt & (bs == 4)
    normal = filt & (bs < 4)
    tc = tc0 + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = W_(normal, torch.clamp(p0 + delta, 0, 255), p0)
    nq0 = W_(normal, torch.clamp(q0 - delta, 0, 255), q0)
    np0 = W_(strong, (2 * p1 + p0 + q1 + 2) >> 2, np0)
    nq0 = W_(strong, (2 * q1 + q0 + p1 + 2) >> 2, nq0)
    return np0, nq0


# ---------------------------------------------------------------------------
# per-MB edge parameters
# ---------------------------------------------------------------------------
def _edge_params(mb_w, mb_h, cls, qp, nnz, mv, ref_idx, slice_id,
                 deblock_idc, alpha_off, beta_off, transform8,
                 chroma_qp_offset):
    """Per-MB, per-edge filter parameters, fully batched.

    Returns dict of planes: bs_v/bs_h [n,4,16] (transform-8x8 masking
    already applied), alpha/beta [n,4] and tc0 [n,4,16] per direction,
    chroma alpha/beta [n,2] + tc0 [n,2,8] per direction, chroma bs
    [n,2,8] per direction.
    """
    n = mb_w * mb_h
    dev = cls.device
    cls = cls.to(torch.int32)
    bs_v, bs_h = compute_bs(mb_w, mb_h, cls, nnz, mv, ref_idx, slice_id,
                            deblock_idc.to(torch.int32))
    qps = torch.where(cls == 8, 0, qp.to(torch.int32))
    aoff = alpha_off.to(torch.int32)
    boff = beta_off.to(torch.int32)
    t8f = (transform8 != 0)[:, None]
    coff = chroma_qp_offset

    # neighbour QP via grid shifts (border lanes are junk but their
    # edges carry bS 0 from compute_bs)
    qg = qps.reshape(mb_h, mb_w)
    qp_left = torch.roll(qg, 1, 1).reshape(n)
    qp_top = torch.roll(qg, 1, 0).reshape(n)
    # interior-edge mask for transform-8x8 MBs (edges 1 and 3 off)
    kmask = on(_T8_OFF, dev)
    bs_v = torch.where(t8f[:, :, None] & kmask[None, :, None], 0, bs_v)
    bs_h = torch.where(t8f[:, :, None] & kmask[None, :, None], 0, bs_h)

    alpha_t = on(ALPHA, dev)
    beta_t = on(BETA, dev)
    cqp_t = on(CHROMA_QP, dev)
    tc0_flat = on(TC0_FLAT, dev)

    def luma_dir(qp_nbr):
        edge0 = (qp_nbr + qps + 1) >> 1                    # [n]
        qpa = torch.cat([edge0[:, None], qps[:, None].expand(n, 3)], 1)
        ia = torch.clamp(qpa + aoff[:, None], 0, 51).long()
        ib = torch.clamp(qpa + boff[:, None], 0, 51).long()
        return alpha_t[ia], beta_t[ib], ia

    def chroma_dir(qp_nbr):
        qcp = cqp_t[torch.clamp(torch.stack([qp_nbr, qps], 1) + coff,
                                0, 51).long()]             # [n,2]
        qcq = cqp_t[torch.clamp(qps + coff, 0, 51).long()][:, None]
        qpa = (qcp + qcq + 1) >> 1
        ia = torch.clamp(qpa + aoff[:, None], 0, 51).long()
        ib = torch.clamp(qpa + boff[:, None], 0, 51).long()
        return alpha_t[ia], beta_t[ib], ia

    p = {"bs_v": bs_v, "bs_h": bs_h}
    for d, qp_nbr, bs in (("v", qp_left, bs_v), ("h", qp_top, bs_h)):
        al, be, ia = luma_dir(qp_nbr)
        p["alpha_" + d] = al
        p["beta_" + d] = be
        p["tc0_" + d] = tc0_flat[ia[:, :, None] * 3
                                 + torch.clamp(bs, 1, 3) - 1]
        bs_c = bs[:, ::2, ::2]                             # [n,2,8]
        alc, bec, iac = chroma_dir(qp_nbr)
        p["bs_c" + d] = bs_c
        p["alpha_c" + d] = alc
        p["beta_c" + d] = bec
        p["tc0_c" + d] = tc0_flat[iac[:, :, None] * 3
                                  + torch.clamp(bs_c, 1, 3) - 1]
    return p


# ---------------------------------------------------------------------------
# plain wavefront
# ---------------------------------------------------------------------------
def _filter_mb_luma(Yl, bs_v, bs_h, a_v, b_v, tc_v, a_h, b_h, tc_h):
    """Filter the 4 vertical then 4 horizontal luma edges of K MBs over
    [K, 24, 24] local windows, in the spec's sequential edge order (8.7:
    later edges consume already-filtered samples); lanes are batched."""
    Yl = Yl.clone()
    for k in range(4):
        ex = 8 + 4 * k
        pc = torch.stack([Yl[:, 8:24, ex - 1 - i] for i in range(4)])
        qc = torch.stack([Yl[:, 8:24, ex + i] for i in range(4)])
        (p0, p1, p2), (q0, q1, q2) = filter_luma(
            pc, qc, bs_v[:, k, :], a_v[:, k, None], b_v[:, k, None],
            tc_v[:, k, :])
        for off, v in ((-1, p0), (-2, p1), (-3, p2), (0, q0), (1, q1),
                       (2, q2)):
            Yl[:, 8:24, ex + off] = v
    for k in range(4):
        ey = 8 + 4 * k
        pr = torch.stack([Yl[:, ey - 1 - i, 8:24] for i in range(4)])
        qr = torch.stack([Yl[:, ey + i, 8:24] for i in range(4)])
        (p0, p1, p2), (q0, q1, q2) = filter_luma(
            pr, qr, bs_h[:, k, :], a_h[:, k, None], b_h[:, k, None],
            tc_h[:, k, :])
        for off, v in ((-1, p0), (-2, p1), (-3, p2), (0, q0), (1, q1),
                       (2, q2)):
            Yl[:, ey + off, 8:24] = v
    return Yl


def _filter_mb_chroma(Cl, bs_cv, bs_ch, a_cv, b_cv, tc_cv, a_ch, b_ch,
                      tc_ch):
    """Filter one chroma plane's 2+2 edges over [K, 16, 16] windows."""
    Cl = Cl.clone()
    for j in range(2):
        ex = 8 + 4 * j
        pc = torch.stack([Cl[:, 8:16, ex - 1 - i] for i in range(2)])
        qc = torch.stack([Cl[:, 8:16, ex + i] for i in range(2)])
        p0, q0 = filter_chroma(pc, qc, bs_cv[:, j, :], a_cv[:, j, None],
                               b_cv[:, j, None], tc_cv[:, j, :])
        Cl[:, 8:16, ex - 1] = p0
        Cl[:, 8:16, ex] = q0
    for j in range(2):
        ey = 8 + 4 * j
        pr = torch.stack([Cl[:, ey - 1 - i, 8:16] for i in range(2)])
        qr = torch.stack([Cl[:, ey + i, 8:16] for i in range(2)])
        p0, q0 = filter_chroma(pr, qr, bs_ch[:, j, :], a_ch[:, j, None],
                               b_ch[:, j, None], tc_ch[:, j, :])
        Cl[:, ey - 1, 8:16] = p0
        Cl[:, ey, 8:16] = q0
    return Cl


_LUMA_KEYS = ("bs_v", "bs_h", "alpha_v", "beta_v", "tc0_v", "alpha_h",
              "beta_h", "tc0_h")
_CHROMA_KEYS = ("bs_cv", "bs_ch", "alpha_cv", "beta_cv", "tc0_cv",
                "alpha_ch", "beta_ch", "tc0_ch")


def _windows(plane, y0s, x0s, T):
    r = torch.arange(T, device=plane.device)
    return plane[(y0s[:, None, None] + r[None, :, None]),
                 (x0s[:, None, None] + r[None, None, :])]


def deblock_mbs_plain(mb_w, Yw, Uw, Vw, params, mbs):
    """Filter the MBs `mbs` (int64 tensor of MB indices whose windows do
    not overlap) as one batched step. Returns new planes."""
    mby, mbx = mbs // mb_w, mbs % mb_w
    y0, x0 = mby * 16 + WPAD - 8, mbx * 16 + WPAD - 8
    cy, cx = mby * 8 + WPAD - 8, mbx * 8 + WPAD - 8
    Yl = _filter_mb_luma(_windows(Yw, y0, x0, 24),
                         *[params[k][mbs] for k in _LUMA_KEYS])
    cp = [params[k][mbs] for k in _CHROMA_KEYS]
    Ul = _filter_mb_chroma(_windows(Uw, cy, cx, 16), *cp)
    Vl = _filter_mb_chroma(_windows(Vw, cy, cx, 16), *cp)
    do = torch.ones_like(mbs, dtype=torch.bool)
    return (scatter_tiles(Yw, Yl, y0, x0, do),
            scatter_tiles(Uw, Ul, cy, cx, do),
            scatter_tiles(Vw, Vl, cy, cx, do))


def deblock_wavefront_plain(mb_w, mb_h, Yw, Uw, Vw, params):
    """Plain version of K2: filter a frame over the slope-2 wavefront,
    one batched step per diagonal. Yw/Uw/Vw: int32 planes padded by
    WPAD; params: _edge_params() output. Returns new planes."""
    diags = diagonals(mb_w, mb_h)
    cnt = (diags >= 0).sum(1)
    diags_t = torch.tensor(diags, device=Yw.device).long()
    planes = tuple(a.to(torch.int32) for a in (Yw, Uw, Vw))
    for d in range(diags.shape[0]):
        planes = deblock_mbs_plain(mb_w, *planes, params,
                                   diags_t[d, :int(cnt[d])])
    return planes


# ---------------------------------------------------------------------------
# K2: the CUDA wavefront (csrc/deblock.cu)
# ---------------------------------------------------------------------------
# packed per-MB param row (int32 lanes), the layout of the TPU kernel's
# _pack_params (losslessh264_tpu/ops/deblock_pallas.py:37-54); the CUDA
# source mirrors these offsets
_PACK_FIELDS = (("bs_v", 64), ("bs_h", 64), ("tc0_v", 64), ("tc0_h", 64),
                ("alpha_v", 4), ("beta_v", 4), ("alpha_h", 4),
                ("beta_h", 4), ("bs_cv", 16), ("bs_ch", 16),
                ("tc0_cv", 16), ("tc0_ch", 16), ("alpha_cv", 2),
                ("beta_cv", 2), ("alpha_ch", 2), ("beta_ch", 2))
PACK_WIDTH = 384


def _pack_params(params):
    """[n, PACK_WIDTH] int32, one row per MB."""
    n = params["bs_v"].shape[0]
    P = torch.cat([params[k].reshape(n, w).to(torch.int32)
                   for k, w in _PACK_FIELDS], 1)
    return torch.nn.functional.pad(P, (0, PACK_WIDTH - P.shape[1]))


def deblock_wavefront(mb_w, mb_h, Yw, Uw, Vw, params):
    """K2 wrapper: the whole frame as one persistent launch of
    csrc/deblock.cu, in place on int32 copies of the planes. CUDA
    tensors only; returns the filtered planes."""
    H, W = mb_h * 16, mb_w * 16
    shapes = ((H + 2 * WPAD, W + 2 * WPAD),
              (H // 2 + 2 * WPAD, W // 2 + 2 * WPAD))
    if (tuple(Yw.shape) != shapes[0] or tuple(Uw.shape) != shapes[1]
            or tuple(Vw.shape) != shapes[1]):
        raise ValueError("deblock planes must be WPAD-padded "
                         f"{shapes}, got {Yw.shape} {Uw.shape} {Vw.shape}")
    dev = Yw.device
    if dev.type != "cuda":
        raise ValueError(f"deblock kernel takes CUDA tensors, got {dev}")
    Y, U, V = (a.to(torch.int32).contiguous().clone() for a in (Yw, Uw, Vw))
    P = _pack_params(params).contiguous()
    if tuple(P.shape) != (mb_w * mb_h, PACK_WIDTH):
        raise ValueError(f"params give {tuple(P.shape)} packed rows, "
                         f"expected ({mb_w * mb_h}, {PACK_WIDTH})")
    # the work-item counter and the per-row progress of luma and chroma;
    # the C entry zeroes them on the stream before the launch
    sync = torch.empty(1 + 2 * mb_h, dtype=torch.int32, device=dev)
    _build.check(_build.lib().pip_deblock_frame(
        ctypes.c_void_p(Y.data_ptr()), ctypes.c_void_p(U.data_ptr()),
        ctypes.c_void_p(V.data_ptr()), Y.stride(0), U.stride(0),
        ctypes.c_void_p(P.data_ptr()), ctypes.c_void_p(sync.data_ptr()),
        mb_w, mb_h, _build.stream(dev)), "deblock")
    _build.count_launch(deblock_wavefront)
    return Y, U, V


deblock_wavefront.launches = 0


def deblock_frame(mb_w, mb_h, Yw, Uw, Vw, cls, qp, nnz, mv, ref_idx,
                  slice_id, deblock_idc, alpha_off, beta_off, transform8,
                  chroma_qp_offset):
    """Filter one frame (spec 8.7).

    Yw/Uw/Vw: int32 working planes padded by WPAD on every side. The
    rest are the per-MB symbol planes (decoder layout);
    chroma_qp_offset is the PPS scalar. CPU tensors take the plain
    wavefront, CUDA tensors the K2 kernel. Returns filtered planes.
    """
    p = _edge_params(mb_w, mb_h, cls, qp, nnz, mv, ref_idx, slice_id,
                     deblock_idc, alpha_off, beta_off, transform8,
                     chroma_qp_offset)
    return deblock_planes(mb_w, mb_h, Yw, Uw, Vw, p)


def deblock_planes(mb_w, mb_h, Yw, Uw, Vw, params):
    """The filtering half of deblock_frame, on _edge_params' output: the
    plain wavefront for CPU tensors, the K2 kernel for CUDA tensors."""
    if Yw.device.type == "cpu":
        return deblock_wavefront_plain(mb_w, mb_h, Yw, Uw, Vw, params)
    return deblock_wavefront(mb_w, mb_h, Yw, Uw, Vw, params)
