"""The work each stage of a frame must do on the card, and the least time
the card could take for it: frozen copies of chip_smoke.py's counts
(k1_bytes, k2_bytes, k3_bytes, k4_bytes, k5_bytes_ops, k6_luma_need,
k6_reads, k6_bytes_ops, k7_bytes_ops, k8_bytes_ops, k9_bytes_ops and
their constants), so that a change to the program cannot move the
yardstick. Bytes are the inputs a stage's outputs depend on, each read
once, and the outputs written once; operations count at the rate of
their type. The program's own constants that the originals read
(deblock's packed-row lanes and width, K9's tables, K3's MB row width)
are copied as numbers; a test holds each copy to its original.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# the H100 SXM's 67 TFLOP/s float32 rate outside the tensor cores,
# halved: an SM has half as many int32 lanes as float32 lanes
INT32_OPS_PER_S = 33.5e12
INT8_OPS_PER_S = 1979e12      # H100 SXM int8 peak (tensor cores, dense)
K1_OPS_PER_POSITION = 50
K3_OPS_PER_MB = 5000
K4_OPS_PER_MB = 48000
K7_OPS_PER_SAMPLE = 16
K8_OPS_PER_SAMPLE = 40
K9_OPS_PER_MB = 32 * 20 + 160 * 4 + 24 * 8
# the program's constants, as numbers
DEBLOCK_PACK_LANES = 344      # sum of ops/deblock._PACK_FIELDS' widths
DEBLOCK_PACK_WIDTH = 384      # ops/deblock.PACK_WIDTH
K9_TABLE_BYTES = 1248         # ops/deblock._K9_TABLES.nbytes
K3_INFO_W = 24                # ops/intra.K3_INFO_W


def least_s(n_bytes, n_ops, ops_per_s=INT32_OPS_PER_S):
    """The least seconds the card could take: bytes over its memory
    bandwidth or operations over their rate, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def k1_bytes(Hp, Wp, entry):
    """Bytes K1 must move: the plane read once, four output planes of
    [Hp-5, Wp-5] written once (the pitch's padding is not needed)."""
    return Hp * Wp + 4 * (Hp - 5) * (Wp - 5) * (4 if entry == "i32" else 1)


def k2_bytes(mb_w, mb_h):
    """Bytes K2 must move: the picture's pixels of Y, U and V (int32)
    read and written once, and the parameter lanes of each MB's packed
    row read once."""
    pixels = 16 * mb_w * 16 * mb_h * 3 // 2
    return 2 * 4 * pixels + 4 * mb_w * mb_h * DEBLOCK_PACK_LANES


def k3_bytes(mb_w, mb_h, B, n_intra):
    """Bytes K3 must move: the int32 working planes (WPAD margin
    included) read and written once, and the residuals and MB rows of the
    intra MBs read once."""
    plane = ((16 * mb_h + 16) * (16 * mb_w + 16)
             + 2 * (8 * mb_h + 16) * (8 * mb_w + 16))
    return 2 * 4 * B * plane + 4 * n_intra * (256 + 128 + K3_INFO_W)


def k4_bytes(mb_w, mb_h, n_intra):
    """Bytes K4 must move: the uint8 source and recon planes once each,
    the inter tiles of the MBs that are not intra, qp and qpc of the intra
    MBs, and the [n, 427] int32 symbol rows written once."""
    n = mb_w * mb_h
    pixels = 256 * n * 3 // 2
    return (2 * pixels + 4 * (n - n_intra) * 384 + 8 * n_intra
            + 4 * n * 427)


def k5_bytes_ops(H, W, R, cur_bytes):
    """(bytes, operations) K5 must take: the source read once (in its
    dtype), the reference window once, the 27n int32 outputs written
    once; an absolute difference, its sum and the running compare for
    every pixel at every displacement."""
    n = (H // 16) * (W // 16)
    n_bytes = cur_bytes * H * W + (H + 2 * R) * (W + 2 * R) + 4 * 27 * n
    return n_bytes, 3 * (2 * R + 1) ** 2 * H * W


def k6_luma_need(fx, fy):
    """[B, 9, 9] bool: the samples of a fix-up cell's 9x9 window that its
    quarter-pel case (fx, fy, [B] each) reads."""
    k = np.arange(9)

    def row_of(lo):
        return (k >= lo) & (k < lo + 4)
    need = np.zeros((len(fx), 9, 9), bool)
    for i, (x, y) in enumerate(zip(fx, fy)):
        if x == 0 and y == 0:
            need[i] = row_of(2)[:, None] & row_of(2)[None, :]
        elif y == 0:
            need[i] = row_of(2)[:, None]
        elif x == 0:
            need[i] = row_of(2)[None, :]
        elif x == 2 or y == 2:
            need[i] = True
        else:
            need[i] = (row_of(2 if y == 1 else 3)[:, None]
                       | row_of(2 if x == 1 else 3)[None, :])
    return need


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def k6_reads(ref_shape, refu_shape, pad, p, mb_w, mb_h):
    """The samples the frame's prediction under the plan `p` depends on,
    each once: (hp, luma, chroma, table cells, fix-up cells), as
    chip_smoke.k6_reads (which takes the rings; only their shapes are
    read)."""
    H, W = 16 * mb_h, 16 * mb_w
    R, Hp, Wp = ref_shape
    cpad = pad // 2
    lpad = 2 * cpad
    Hc, Wc = H // 2, W // 2
    o3 = np.arange(3)
    bucket = _host(p["mc_bucket"]).reshape(
        mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3).reshape(4 * mb_h, 4 * mb_w)
    nuniq = int(p["mc_nuniq"])
    slots = np.asarray(p["mc_slots"]).astype(np.int64)
    act = [int(slots[0]), int(slots[1]) if p["mc_nslots"] > 1
           else int(slots[0])]
    chroma = np.zeros(refu_shape, bool)

    def mark_chroma(slot, y, x, fy, fx):
        keep = ((o3[None, :, None] < 2 + (fy > 0)[:, None, None])
                & (o3[None, None, :] < 2 + (fx > 0)[:, None, None]))
        ys = np.broadcast_to(y[:, None, None] + o3[None, :, None],
                             keep.shape)
        xs = np.broadcast_to(x[:, None, None] + o3[None, None, :],
                             keep.shape)
        ss = np.broadcast_to(slot[:, None, None], keep.shape)
        chroma[ss[keep], ys[keep], xs[keep]] = True

    cr, cc = np.nonzero(bucket < nuniq)
    e = np.asarray(p["mc_uniq"]).astype(np.int64)[bucket[cr, cc]]
    o4 = np.arange(4)
    hp = np.zeros((2, 4, Hp - 5, Wp - 5), bool)
    for pl, dy, dx in ((3, 4, 5), (6, 7, 8)):
        ys = (pad - 2 + e[:, 1] + 4 * cr + e[:, dy])[:, None, None] \
            + o4[None, :, None]
        xs = (pad - 2 + e[:, 2] + 4 * cc + e[:, dx])[:, None, None] \
            + o4[None, None, :]
        hp[e[:, 0][:, None, None], e[:, pl][:, None, None], ys, xs] = True
    mark_chroma(np.array(act)[e[:, 0]], cpad + e[:, 9] + 2 * cr,
                cpad + e[:, 10] + 2 * cc, e[:, 11], e[:, 12])

    fix = _host(p["mc_fix"])
    fix = fix[fix >= 0].astype(np.int64)
    mb, k = fix // 16, fix % 16
    y0 = (mb // mb_w) * 16 + (k // 4) * 4
    x0 = (mb % mb_w) * 16 + (k % 4) * 4
    slot = np.clip(_host(p["ref_slot"]).reshape(-1)[fix], 0, R - 1)
    mv = _host(p["mv"]).reshape(-1, 2)[fix].astype(np.int64)
    vx, vy = mv[:, 0], mv[:, 1]
    fullx = np.clip(4 * x0 + vx, (2 - pad) * 4, (W + pad - 19) * 4)
    fully = np.clip(4 * y0 + vy, (2 - pad) * 4, (H + pad - 19) * 4)
    need = k6_luma_need(fullx & 3, fully & 3)
    b, r, c = np.nonzero(need)
    luma = np.zeros(ref_shape, bool)
    luma[slot[b], pad + (fully[b] >> 2) - 2 + r,
         pad + (fullx[b] >> 2) - 2 + c] = True
    cfx = np.clip(4 * x0 + vx, (2 - lpad) * 4, (2 * Wc + lpad - 19) * 4)
    cfy = np.clip(4 * y0 + vy, (2 - lpad) * 4, (2 * Hc + lpad - 19) * 4)
    mark_chroma(slot, cpad + (cfy >> 3), cpad + (cfx >> 3), cfy & 7,
                cfx & 7)
    return hp, luma, chroma, len(cr), len(fix)


def k6_bytes_ops(ref_shape, refu_shape, pad, p, mb_w, mb_h):
    """(bytes, operations) K6 must take for the plan `p` on rings of
    these shapes: the bucket plane, the fix list and the table, the
    samples of k6_reads (U and V alike), each fix-up cell's ref_slot and
    mv, and the three int32 planes written once. Operations: a table
    cell's luma pixel is 3, a chroma one 9; a fix-up cell's luma pixel
    K1_OPS_PER_POSITION, its chroma pixels 9 each."""
    H, W = 16 * mb_h, 16 * mb_w
    hp, luma, chroma, cells, fix = k6_reads(ref_shape, refu_shape, pad, p,
                                            mb_w, mb_h)
    per_fix = p["ref_slot"].element_size() + 2 * p["mv"].element_size()
    n_bytes = (16 * mb_w * mb_h + p["mc_fix"].numel() * 4 + 32 * 16 * 4
               + int(hp.sum()) + int(luma.sum()) + 2 * int(chroma.sum())
               + fix * per_fix + 6 * H * W)
    return n_bytes, (cells * (16 * 3 + 2 * 4 * 9)
                     + fix * (16 * K1_OPS_PER_POSITION + 2 * 4 * 9))


def k7_bytes_ops(mb_w, mb_h, p, has_pred):
    """(bytes, operations) K7 must take for the frame `p`: the five per-MB
    bytes and the ref_slot row of every MB; the levels of the blocks each
    MB's path reads; the int32 prediction of the inter MBs that are not
    PCM, a PCM MB's 384 bytes and, with use_scaling, the weight matrices;
    and the padded int32 planes and residual tiles written once.
    Operations: K7_OPS_PER_SAMPLE for each of an MB's 384 samples.
    (chip_smoke.k7_bytes_ops takes the prediction plane; only whether it
    exists is read, which `has_pred` says.)"""
    n = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    g = {k: _host(p[k]).astype(np.int64) for k in (
        "mb_class", "cbp_luma", "cbp_chroma", "transform8", "ref_slot")}
    cls, cbp, cbpc = g["mb_class"], g["cbp_luma"], g["cbp_chroma"]
    i16 = cls == 1
    t8 = (g["transform8"] != 0) & ~i16
    coded8 = sum((cbp >> b) & 1 for b in range(4))
    luma = np.where(t8, coded8 * (128 if "luma8" in p else 0),
                    np.where(i16, 16 * 32 + 32, coded8 * 4 * 32))
    chroma = (cbpc != 0) * 16 + (cbpc == 2) * 8 * 32
    pcm = (cls == 8) & ("pcm" in p)
    inter = (g["ref_slot"] >= 0).all(1) & ~pcm & bool(has_pred)
    n_bytes = (n * (5 + 64) + int(luma.sum()) + int(chroma.sum())
               + int(inter.sum()) * 384 * 4 + int(pcm.sum()) * 384
               + (6 * 64 + 2 * 256 if p["use_scaling"] else 0)
               + 4 * ((H + 16) * (W + 16) + 2 * (H // 2 + 16) * (W // 2 + 16))
               + 4 * 384 * n)
    return n_bytes, K7_OPS_PER_SAMPLE * 384 * n


def k8_bytes_ops(mb_w, mb_h, args):
    """(bytes, operations) K8 must take for inter_residual's arguments
    `args`: the source planes, pred_q, the quadrants' MVs and the per-MB
    SAD, partition, x offset, qp and qpc, once; the chroma reference
    samples the quadrants' bilinear windows weigh by more than 0, each
    once, U and V alike; the outputs written once. Operations:
    K8_OPS_PER_SAMPLE for each of an MB's 384 samples."""
    Y, U, V, pred_q, mvqx, mvqy = args[:6]
    refU, xoffC = args[8], args[10]
    n = mb_w * mb_h
    Hc, Wc = refU.shape
    mx, my, xo = (_host(a).astype(np.int64) for a in (mvqx, mvqy, xoffC))
    quad, mbi = np.arange(4), np.arange(n)
    cy = (((mbi // mb_w) * 8)[:, None] + (quad // 2) * 4).reshape(-1)
    cx = (((mbi % mb_w) * 8 + xo)[:, None] + (quad % 2) * 4).reshape(-1)
    iy = np.clip(16 + cy + (my >> 3), 0, Hc - 5)
    ix = np.clip(16 + cx + (mx >> 3), 0, Wc - 5)
    o = np.arange(5)
    keep = ((o[None, :, None] < 4 + ((my & 7) > 0)[:, None, None])
            & (o[None, None, :] < 4 + ((mx & 7) > 0)[:, None, None]))
    ys = np.broadcast_to(iy[:, None, None] + o[None, :, None], keep.shape)
    xs = np.broadcast_to(ix[:, None, None] + o[None, None, :], keep.shape)
    mask = np.zeros((Hc, Wc), bool)
    mask[ys[keep], xs[keep]] = True
    n_bytes = ((Y.numel() + U.numel() + V.numel()) * Y.element_size()
               + 4 * (pred_q.numel() + 8 * n + 5 * n) + 2 * int(mask.sum())
               + n * (2 + 4 * (1 + 8 + 256 + 8 + 128 + 256 + 128)))
    return n_bytes, K8_OPS_PER_SAMPLE * 384 * n


def k9_bytes_ops(mb_w, mb_h, args):
    """(bytes, operations) K9 must take for edge_params_packed's arguments
    `args` (after mb_w, mb_h): each plane's distinct elements read once in
    their own dtype (an expanded view's once), the table operand, and the
    [n, 384] int32 rows written once. Operations: K9_OPS_PER_MB per MB."""
    n = mb_w * mb_h
    n_bytes = K9_TABLE_BYTES + 4 * n * DEBLOCK_PACK_WIDTH
    for a in args[:10]:
        if hasattr(a, "element_size"):
            distinct = 1
            for size, stride in zip(a.shape, a.stride()):
                distinct *= size if stride else 1
            n_bytes += distinct * a.element_size()
    return n_bytes, K9_OPS_PER_MB * n
