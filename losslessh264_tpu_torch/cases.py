"""Seeded inputs shared by the tests, chip_smoke.py and tools/kernel_ab.py:
random cases for holding K2 (csrc/deblock.cu), K3 (csrc/intra_dec.cu),
K4 (csrc/intra_enc.cu), K5 (csrc/me_dense.cu), K6 (csrc/mc_bucket.cu),
K7 (csrc/residual_dec.cu), K8 (csrc/residual_enc.cu) and K9
(csrc/deblock_params.cu) against their plain versions, so that all three
check and time the same cases (and HeldToPlain, which holds a wrapper to its plain version on a whole
run), the translating noise frames the encoder's tests encode, the frames of the decoder's intra
routes (tests/data/runs720p.264 and the run tests), and the encoders of
the encode goldens' configurations (tests/data/synth720p_enc_golden*.json)."""
import numpy as np
import torch

from .ops import deblock as tdb

SYMBOL_KEYS = ("cls", "qp", "nnz", "mv", "ref_idx", "slice_id",
               "deblock_idc", "alpha_off", "beta_off", "transform8")


def block_noise(rng, h, w):
    """An [h, w] int32 plane of 8x8 blocks of noise around 128 with
    amplitude 4, 16, 64 or 256: the low-contrast blocks make every
    filter branch fire, the full-range ones leave edges unfiltered."""
    amp = rng.choice([4, 16, 64, 256], ((h + 7) // 8, (w + 7) // 8))
    amp = np.kron(amp, np.ones((8, 8), np.int64))[:h, :w]
    return (rng.randint(0, 256, (h, w)) * amp // 256
            + 128 - amp // 2).astype(np.int32)


def random_deblock_case(mb_w, mb_h, seed, device):
    """(planes, sym, params): WPAD-padded Y/U/V planes of block noise,
    random symbol planes in SYMBOL_KEYS order (the symbol recipe of
    tests/test_deblock_impls.py, with deblocking switched off or offset
    on some MBs) and their _edge_params, chroma_qp_offset = seed."""
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    P = tdb.WPAD
    planes = [torch.as_tensor(block_noise(rng, *s), device=device)
              for s in ((H + 2 * P, W + 2 * P),
                        (H // 2 + 2 * P, W // 2 + 2 * P),
                        (H // 2 + 2 * P, W // 2 + 2 * P))]
    sym = dict(
        cls=rng.randint(0, 9, (n,)), qp=rng.randint(10, 52, (n,)),
        nnz=rng.randint(0, 3, (n, 16)), mv=rng.randint(-16, 17, (n, 16, 2)),
        ref_idx=rng.randint(0, 2, (n, 16)),
        slice_id=np.arange(n) // (mb_w * 2),
        deblock_idc=rng.choice([0, 0, 0, 1, 2], (n,)),
        alpha_off=rng.randint(-6, 7, (n,)) * 2,
        beta_off=rng.randint(-6, 7, (n,)) * 2,
        transform8=rng.randint(0, 2, (n,)))
    sym = [torch.as_tensor(np.asarray(sym[k], np.int32), device=device)
           for k in SYMBOL_KEYS]
    return planes, sym, tdb._edge_params(mb_w, mb_h, *sym, seed)


# K9's cases: (name, mb_w, mb_h, seed, options of random_edge_case). Every
# class (PCM included), transform8 on intra and inter MBs, slices that
# start mid-row, MV differences of 3, 4 and -4 between neighbouring cells,
# alpha / beta offsets of -12 and +12; the decoder's dtypes, int32, and the
# encoder's planes (bool nnz, a per-MB ref_idx expanded to its cells,
# absent offsets and transform8, one deblock_idc for the frame); qp 0 and
# 51 everywhere, chroma QP offsets of -12 and +12, deblock_idc 1 and 2
# everywhere; frames of one MB, one MB column and row, and 720p.
K9_CASES = [
    ("1x1", 1, 1, 0, {}),
    ("1x5", 1, 5, 1, {}),
    ("5x1", 5, 1, 2, {}),
    ("9x4 decoder dtypes", 9, 4, 3, {}),
    ("9x4 int32", 9, 4, 4, dict(dtypes="int32")),
    ("9x4 encoder planes, idc 0", 9, 4, 5, dict(dtypes="encoder", idc=0)),
    ("9x4 encoder planes, idc 2", 9, 4, 6, dict(dtypes="encoder", idc=2)),
    ("9x4 qp 0", 9, 4, 7, dict(qp=0)),
    ("9x4 qp 51", 9, 4, 8, dict(qp=51)),
    ("9x4 chroma offset -12", 9, 4, 9, dict(coff=-12)),
    ("9x4 chroma offset +12", 9, 4, 10, dict(coff=12)),
    ("9x4 idc 1", 9, 4, 11, dict(idc=1)),
    ("9x4 idc 2", 9, 4, 12, dict(idc=2)),
    ("720p decoder dtypes", 80, 45, 13, {}),
    ("720p encoder planes", 80, 45, 14, dict(dtypes="encoder", idc=0)),
]
# the decoder's dtypes of the planes (decoder_torch.planes_to_torch of the
# symbol layer's buffers; nnz is TorchDecoder._nnz_plane's int64)
_DECODER_DTYPES = (np.uint8, np.uint8, np.int64, np.int16, np.int8,
                   np.uint8, np.uint8, np.int8, np.int8, np.uint8)


def random_edge_case(mb_w, mb_h, seed, device="cpu", dtypes="decoder",
                     qp=None, coff=None, idc=None):
    """The arguments of ops/deblock.edge_params_packed (after mb_w, mb_h)
    for one frame: (cls, qp, nnz, mv, ref_idx, slice_id, deblock_idc,
    alpha_off, beta_off, transform8, chroma_qp_offset). Every class 0-8
    (each present from 9 MBs on),
    qp over 0..51 with 0 and 51 present (or the int `qp`), nnz counts 0-3,
    MVs whose neighbouring cells differ by 0, 3, 4, 6, 7 or 8 (and a few
    by hundreds), ref_idx -1, 0 or 1 per cell, slices that start mid-row
    (one at least where a row has two MBs) with a deblock_idc of 0, 1 or
    2 each (or the int `idc` everywhere),
    alpha / beta offsets over -12..12 with both ends present, transform8
    on 40% of the MBs of every class, chroma_qp_offset in -12..12 (or
    `coff`). dtypes: "decoder" (_DECODER_DTYPES), "int32", or "encoder"
    (encoder_torch._deblock_recon's planes: int32, bool nnz, ref_idx an
    expanded [n] plane, no alpha_off, beta_off or transform8, deblock_idc
    the int `idc`)."""
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    cls = rng.choice(9, n, p=[0.1, 0.08, 0.08, 0.2, 0.12, 0.12, 0.12, 0.1,
                              0.08])
    if n >= 9:
        cls[rng.choice(n, 9, replace=False)] = np.arange(9)
    qps = np.full(n, qp) if qp is not None else rng.randint(0, 52, n)
    offs = rng.randint(-6, 7, (2, n)) * 2
    if n >= 2:
        if qp is None:
            qps[rng.choice(n, 2, replace=False)] = (0, 51)
        for o in offs:
            o[rng.choice(n, 2, replace=False)] = (-12, 12)
    nnz = rng.randint(1, 4, (n, 16)) * (rng.rand(n, 16) < 0.3)
    mv = (rng.randint(-2, 3, (n, 1, 2)) * 2
          + rng.choice([0, 0, 3, -3, 4, -4], (n, 16, 2)))
    mv += (rng.rand(n, 16, 2) < 0.03) * rng.choice([-300, 300], (n, 16, 2))
    ref_mb = rng.choice([-1, 0, 0, 1], n)
    ref = rng.choice([-1, 0, 0, 1], (n, 16))
    sid = _slice_rows(rng, mb_w, mb_h)
    if mb_w > 1:    # and one more slice, from a random MB inside a row
        start = rng.randint(0, n // mb_w) * mb_w + rng.randint(1, mb_w)
        sid[start:] += 1
    idcs = (rng.choice([0, 0, 1, 2], sid.max() + 1)[sid] if idc is None
            else np.full(n, idc))
    t8 = rng.rand(n) < 0.4
    if coff is None:
        coff = int(rng.randint(-12, 13))

    def T(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=device)

    planes = (cls, qps, nnz, mv, ref, sid, idcs, offs[0], offs[1], t8)
    if dtypes == "decoder":
        out = [T(a, dt) for a, dt in zip(planes, _DECODER_DTYPES)]
    elif dtypes == "int32":
        out = [T(a, np.int32) for a in planes]
    elif dtypes == "encoder":
        out = [T(a, np.int32) for a in planes[:3]]
        out[2] = out[2] != 0
        out += [T(mv, np.int32), T(ref_mb, np.int32)[:, None].expand(n, 16),
                T(sid, np.int32), int(idc or 0), None, None, None]
    else:
        raise ValueError(f"dtypes {dtypes!r}: decoder, int32 or encoder")
    return (*out, coff)


def moving_frames(n=4, W=64, H=48, seed=7):
    """n I420 frames (uint8 numpy Y, U, V) of noise moving by (2, 3) px
    per frame under flat chroma: the recipe of the JAX encoder's tests
    (tests/test_encoder_jax.py::_moving_frames)."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, (H + 32, W + 32)).astype(np.uint8)
    frames = []
    for i in range(n):
        Y = np.ascontiguousarray(bg[i * 2:i * 2 + H, i * 3:i * 3 + W])
        U = np.full((H // 2, W // 2), 100 + i, np.uint8)
        V = np.full((H // 2, W // 2), 200, np.uint8)
        frames.append((Y, U, V))
    return frames


def patch_frames(width, height, plan, noise=0, seed=0):
    """len(plan) I420 frames (uint8 numpy Y, U, V) whose P frames put
    intra MBs on chosen MB diagonals (d = 2 * mby + mbx): a smooth luma
    pattern with a texture of amplitude 10 (50..200), translating by
    (2, 3) px per frame (a motion search finds that one vector, so the
    P frames take the decoder's bucketed MC), with fresh noise of
    amplitude `noise` on every luma sample, and on frame i one
    MB per diagonal of plan[i] (in the first MB row that holds it)
    filled with fresh noise of amplitude 5 around 250 on odd frames and
    around 5 on even ones. Neither the pattern nor the previous frame's
    patches predict such an MB, so an encoder's P frame codes it intra
    (and often the MBs that the previous frame's patches covered in its
    reference). Chroma is flat."""
    rng = np.random.RandomState(seed)
    mb_w, mb_h = width // 16, height // 16
    n = len(plan)
    tex = rng.randint(-10, 11, (height + 2 * n, width + 3 * n))
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    frames = []
    for i, diags in enumerate(plan):
        Y = (125 + 35 * np.sin((xx + 3 * i) / 23.0)
             + 30 * np.cos((yy + 2 * i) / 17.0)).round()
        Y += tex[2 * i:2 * i + height, 3 * i:3 * i + width]
        if noise:
            Y += rng.randint(-noise, noise + 1, Y.shape)
        for d in diags:
            y = max(0, -(-(d - mb_w + 1) // 2))
            x = d - 2 * y
            if not (0 <= x < mb_w and y < mb_h):
                raise ValueError(f"no MB on diagonal {d}")
            Y[y * 16:y * 16 + 16, x * 16:x * 16 + 16] = \
                (250 if i % 2 else 5) + rng.randint(-5, 6, (16, 16))
        frames.append((np.clip(Y, 0, 255).astype(np.uint8),
                       np.full((height // 2, width // 2), 110, np.uint8),
                       np.full((height // 2, width // 2), 150, np.uint8)))
    return frames


def golden_encoder(cfg, width, height, device):
    """The port's encoder of one configuration of an encode golden (its
    JSON entry: `kwargs` with an optional `rc` spec, `simulcast`, or
    `older`, the older fixed-QP Encoder), built as
    tools/gen_enc_golden.make_encoder builds the JAX package's."""
    from . import ratectl
    from .encoder import Encoder
    from .encoder_torch import TorchEncoder
    from .simulcast import SimulcastEncoder
    if "older" in cfg:
        return Encoder(width, height, device=device, **cfg["older"])
    if "simulcast" in cfg:
        return SimulcastEncoder(width, height, device=device,
                                **cfg["simulcast"])
    kw = dict(cfg["kwargs"])
    if "rc" in cfg:
        spec = dict(cfg["rc"])
        kw["rc"] = getattr(ratectl, spec.pop("kind"))(
            spec.pop("bitrate_bps"), spec.pop("fps"), **spec)
    return TorchEncoder(width, height, device=device, **kw)



# I4x4 (I8x8 with transform8), I16x16, I8x8, P, PCM
INTRA_CLASSES = (0, 1, 2, 3, 8)


def _slice_rows(rng, mb_w, mb_h):
    """[n] slice ids: slices that start at random MBs, so a slice boundary
    can fall in the middle of a row (aT false below it mid-frame)."""
    n = mb_w * mb_h
    k = rng.randint(0, min(4, n))
    starts = np.sort(rng.choice(np.arange(1, n), k, replace=False)) \
        if n > 1 and k else np.zeros(0, np.int64)
    sid = np.zeros(n, np.int64)
    for s in starts:
        sid[s:] += 1
    return sid


def random_intra_case(mb_w, mb_h, B, seed, device="cpu", classes=None,
                      t8_share=0.4):
    """The inputs of the decoder's intra pass for B frames, as numpy-made
    tensors on `device`, each with a leading frame axis: the WPAD-padded
    int32 working planes (Yw, Uw, Vw: random pixels at inter and PCM MBs,
    0 at intra MBs and in the margin), the residuals (res_y [B,n,16,16],
    res_u / res_v [B,n,8,8]: sparse, some large enough to clip) and the
    INTRA_KEYS planes of decoder_torch as a dict p: every class of
    INTRA_CLASSES (or, given `classes`, those drawn uniformly), transform8
    on a `t8_share` of the MBs (I8x8 where the class is I4x4), every I4x4
    / I8x8 / I16x16 / chroma mode, and availability from slices that
    start mid-row, with some flags dropped as constrained intra drops
    them. classes=(0,), t8_share=0 gives a frame of I4x4 MBs only."""
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    P = tdb.WPAD
    planes = {k: np.zeros((B,) + s, np.int32) for k, s in (
        ("Y", (H + 2 * P, W + 2 * P)), ("U", (H // 2 + 2 * P, W // 2 + 2 * P)),
        ("V", (H // 2 + 2 * P, W // 2 + 2 * P)))}
    p = {k: [] for k in ("mb_class", "avail", "transform8", "i4_modes",
                         "i16_mode", "chroma_mode")}
    my, mx = np.divmod(np.arange(n), mb_w)
    for b in range(B):
        cls = (rng.choice(INTRA_CLASSES, n, p=[0.3, 0.2, 0.2, 0.2, 0.1])
               if classes is None else rng.choice(classes, n))
        sid = _slice_rows(rng, mb_w, mb_h)
        grid = sid.reshape(mb_h, mb_w)

        def same(dy, dx):
            y, x = my + dy, mx + dx
            ok = (y >= 0) & (x >= 0) & (x < mb_w)
            return ok & (grid[np.clip(y, 0, mb_h - 1),
                              np.clip(x, 0, mb_w - 1)] == sid)

        avail = np.stack([same(0, -1), same(-1, 0), same(-1, -1),
                          same(-1, 1)], 1) & (rng.rand(n, 4) < 0.85)
        p["mb_class"].append(cls.astype(np.uint8))
        p["avail"].append(avail)
        p["transform8"].append((rng.rand(n) < t8_share).astype(np.uint8))
        p["i4_modes"].append(rng.randint(0, 9, (n, 16)).astype(np.int8))
        p["i16_mode"].append(rng.randint(0, 4, n).astype(np.uint8))
        p["chroma_mode"].append(rng.randint(0, 4, n).astype(np.uint8))
        keep = ~np.isin(cls, [0, 1, 2]).reshape(mb_h, mb_w)
        for k, t in (("Y", 16), ("U", 8), ("V", 8)):
            pix = rng.randint(0, 256, (mb_h * t, mb_w * t))
            pix *= np.kron(keep, np.ones((t, t), np.int64))
            planes[k][b, P:P + mb_h * t, P:P + mb_w * t] = pix

    def residual(t):
        r = rng.randint(-40, 41, (B, n, t, t))
        r[rng.rand(B, n, t, t) < 0.4] = 0
        big = rng.rand(B, n, t, t) < 0.03
        r[big] = rng.choice([-255, 255], int(big.sum()))
        return r.astype(np.int32)

    res = [residual(16), residual(8), residual(8)]

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return (T(planes["Y"]), T(planes["U"]), T(planes["V"]), *map(T, res),
            {k: T(np.stack(v)) for k, v in p.items()})


def random_intra_encode_case(mb_w, mb_h, seed, qp, mask=None):
    """The numpy inputs of the encoder's intra wavefront for one frame:
    source planes (uint8: smooth ramps, flat MBs and noise, so that both
    I16x16 and I4x4 win somewhere), inter tiles (random at the MBs that
    are not intra, 0 at intra ones), the intra mask, per-MB qp (the int
    `qp` everywhere, or "aq": a random plane over 0..51) and chroma qp,
    and a row_slice with a slice boundary on some rows. The mask is all
    MBs on even seeds and a random half on odd ones, or with
    mask="stripes" every MB but those with (x + y) % 3 == 2: along each
    row two intra MBs, then an inter one, so that intra MBs have intra
    and inter left, top and top-right neighbours. Returns a dict."""
    from .ref_np import CHROMA_QP
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    yy, xx = np.mgrid[:H, :W]
    Y = (yy * rng.randint(1, 6) + xx * rng.randint(1, 6)) % 256
    kind = rng.randint(0, 3, (mb_h, mb_w))       # 0 ramp, 1 flat, 2 noise
    kind = np.kron(kind, np.ones((16, 16), np.int64))
    Y = np.where(kind == 1, 120 + rng.randint(-2, 3, (H, W)), Y)
    Y = np.where(kind == 2, rng.randint(0, 256, (H, W)), Y)
    U = rng.randint(90, 110, (H // 2, W // 2))
    V = (yy[:H // 2, :W // 2] * 7 + rng.randint(0, 9, (H // 2, W // 2))) % 256
    is_intra = (np.ones(n, bool) if seed % 2 == 0
                else rng.rand(n) < 0.5)
    if mask == "stripes":
        my, mx = np.divmod(np.arange(n), mb_w)
        is_intra = (mx + my) % 3 != 2
    elif mask is not None:
        raise ValueError(f"unknown intra mask {mask!r}")
    inter = [rng.randint(0, 256, (n, t, t)).astype(np.int32)
             * (~is_intra)[:, None, None] for t in (16, 8, 8)]
    if qp == "aq":
        qps = rng.randint(0, 52, n)
    else:
        qps = np.full(n, qp)
    row_slice = np.concatenate([[0], np.cumsum(rng.rand(mb_h - 1) < 0.4)])
    return dict(srcY=Y.astype(np.uint8), srcU=U.astype(np.uint8),
                srcV=V.astype(np.uint8), inter_y=inter[0], inter_u=inter[1],
                inter_v=inter[2], is_intra=is_intra,
                qp=qps.astype(np.int32),
                qpc=np.asarray(CHROMA_QP)[qps].astype(np.int32),
                row_slice=row_slice.astype(np.int32))


# K5's cases: (name, H, W, radius, plane kind, seed, scroll_dy, cur dtype,
# strided). 720p at the encoder's radius on noise, on a flat plane (every
# displacement ties) and on a periodic one (many tie); 64x48 at radius
# 4-6; the simulcast layer's 40x23 MBs, the graft's radius 8, 30x7 MBs
# (not a multiple of the kernel's 4-MB tile), scrolled windows and the
# largest radius the kernel's key holds; 1080p, radius 0, 1 and 3, and
# widths of 5, 9 and 13 MBs (one past a multiple of the kernel's 4-MB
# tile); windows scrolled so that the best dy is the last (+R) or the
# first (-R) of the search (cur matches the reference at (dy, dx) =
# (-1 - scroll_dy, -2)). A strided reference is a slice of a PAD-padded
# plane, as encode_inter_mbs takes it.
K5_CASES = [
    ("720p random", 720, 1280, 16, "random", 0, 0, "int32", True),
    ("720p flat", 720, 1280, 16, "flat", 1, 0, "int32", True),
    ("720p periodic", 720, 1280, 16, "periodic", 2, 0, "uint8", True),
    ("64x48 radius 4", 48, 64, 4, "random", 3, 0, "int32", False),
    ("64x48 radius 5", 48, 64, 5, "periodic", 4, 0, "int32", False),
    ("64x48 radius 6", 48, 64, 6, "flat", 5, 0, "uint8", False),
    ("640x368 (40x23 MBs)", 368, 640, 16, "random", 6, 0, "int32", True),
    ("720p radius 8", 720, 1280, 8, "random", 7, 0, "int32", True),
    ("480x112 (30x7 MBs)", 112, 480, 16, "periodic", 8, 0, "int32", True),
    ("720p scroll_dy 9", 720, 1280, 16, "random", 9, 9, "int32", True),
    ("64x48 scroll_dy -11", 48, 64, 16, "random", 10, -11, "int32", True),
    ("96x48 radius 22", 48, 96, 22, "random", 11, 0, "int32", False),
    ("1080p (120x68 MBs)", 1088, 1920, 16, "random", 12, 0, "uint8", True),
    ("80x48 radius 0 (5x3 MBs)", 48, 80, 0, "random", 13, 0, "int32", True),
    ("144x32 radius 1 (9x2 MBs)", 32, 144, 1, "periodic", 14, 0, "int32",
     False),
    ("208x64 radius 3 (13x4 MBs)", 64, 208, 3, "random", 15, 0, "int32",
     True),
    ("160x96 radius 8 scroll_dy -9 (best dy +8)", 96, 160, 8, "random", 16,
     -9, "int32", True),
    ("160x96 scroll_dy 15 (best dy -16)", 96, 160, 16, "random", 17, 15,
     "int32", True),
]
K5_PAD = 32


def search_plane(kind, shape, rng):
    """A uint8 plane: noise, flat (77), or periodic (period 4 in x, 2 in
    y: every 4th horizontal and 2nd vertical shift matches as well)."""
    H, W = shape
    if kind == "random":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "flat":
        return np.full(shape, 77, np.uint8)
    yy, xx = np.mgrid[:H, :W]
    return ((xx % 4) * 40 + (yy % 2) * 90 + 10).astype(np.uint8)


def dense_search_case(H, W, radius, kind, seed, scroll_dy=0, cur_dtype="int32",
                      strided=True, device="cpu"):
    """(cur [H, W], ref_pad [H+2R, W+2R] uint8) for dense_full_search:
    cur is the reference moved by (1, 2) px, with noise on the random
    plane. Strided: ref_pad is the slice at rows PAD-R+scroll_dy and
    columns PAD-R of the edge-padded [H+2PAD, W+2PAD] reference (PAD =
    K5_PAD), as the encoder slices its reference; else a contiguous
    plane (scroll_dy 0)."""
    rng = np.random.default_rng(seed)
    base = search_plane(kind, (H + 8, W + 8), rng)
    cur = base[3:3 + H, 2:2 + W].astype(np.int32)
    if kind == "random":
        cur = np.clip(cur + rng.integers(-6, 7, cur.shape), 0, 255)
    ref = base[4:4 + H, 4:4 + W]
    cur = torch.as_tensor(cur.astype(cur_dtype), device=device)
    if not strided:
        if scroll_dy:
            raise ValueError("a scrolled window needs the padded plane")
        return cur, torch.as_tensor(np.pad(ref, radius, mode="edge"),
                                    device=device)
    o = K5_PAD - radius + scroll_dy
    if not (0 <= o and o + 2 * radius <= 2 * K5_PAD):
        raise ValueError(f"radius {radius} scroll {scroll_dy} leaves the "
                         "padding")
    plane = torch.as_tensor(np.pad(ref, K5_PAD, mode="edge"), device=device)
    c = K5_PAD - radius
    return cur, plane[o:o + H + 2 * radius, c:c + W + 2 * radius]


# K6's cases: (name, mb_w, mb_h, seed, main triples, active slots, MBs of
# extra triples, edge MVs). One or two (slot, mv) triples per slot up to
# the 32 the table holds; the 32 + 32 case spills exactly 32 MBs (512
# cells, MC_FIX_CAP) to the fix-ups; the edge case puts MVs at
# +-MC_MV_MAX (the frame's right and bottom cells then clip and take the
# fix-ups too). With edge "far" the extra MBs are far MBs instead: every
# cell its own slot of the whole ring (the two active slots and the two
# others) and its own MV, longer than MC_MV_MAX, half of them so long that
# the iFullMV clip engages (on all four sides across the MBs), and the
# four corner MBs among them; every far cell is a fix-up cell.
K6_CASES = [
    ("720p 1 triple", 80, 45, 0, 1, 1, 0, False),
    ("720p 2 triples, 2 slots", 80, 45, 1, 2, 2, 0, False),
    ("720p 32 triples", 80, 45, 2, 32, 1, 0, False),
    ("720p 32 triples, 2 slots, 512 fix-ups", 80, 45, 3, 32, 2, 32, False),
    ("720p MVs at +-MC_MV_MAX", 80, 45, 4, 12, 2, 0, True),
    ("9x4 MBs 5 triples, 2 slots", 9, 4, 5, 5, 2, 3, False),
    ("720p 2 triples, 32 far MBs", 80, 45, 6, 2, 1, 32, "far"),
    ("720p 20 triples, 2 slots, 12 far MBs", 80, 45, 7, 20, 2, 12, "far"),
    ("9x4 MBs 3 triples, 2 slots, 8 far MBs", 9, 4, 8, 3, 2, 8, "far"),
]


def random_mc_case(mb_w, mb_h, seed, n_main, n_slots, n_extra, edge,
                   device="cpu"):
    """(ref_y, ref_u, ref_v, pad, p) for mc_bucketed: uint8 rings of 4
    noise slots (pad 32), and the plane dict of a frame whose MBs each
    carry one (slot, mv) triple: the first n_main MBs one main triple
    each, then the other MBs a random main one, but n_extra MBs at random
    places a fresh triple each (the table keeps the 32 most populated
    triples; the rest spill to the fix-ups); every 40th MB is intra
    (ref_slot -1). Slots 1 and 3 of the ring are the active ones; MVs
    are |mv| <= 64 quarter-pels, and with `edge` True four main triples
    sit at (+-MC_MV_MAX, +-MC_MV_MAX). With `edge` "far" the n_extra MBs
    (the four corner MBs and random others) are far MBs: each cell a slot
    of the whole ring and an MV of MC_MV_MAX + 1 to 200 quarter-pels per
    component (half the cells) or of MC_MV_MAX + 1 to 4 (W + 2 pad) (the
    other half, which the iFullMV clip mostly pulls back into the padded
    planes). ref_slot is int32 and mv int16, as the decoder uploads them.
    The plan is mc_fast_plan's; raises if it does not serve the frame."""
    from .decoder_torch import planes_to_torch
    from .ops import mc as tmc
    rng = np.random.RandomState(seed)
    pad, R = 32, 4
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    ref_y = rng.randint(0, 256, (R, H + 2 * pad, W + 2 * pad))
    ref_u = rng.randint(0, 256, (R, H // 2 + pad, W // 2 + pad))
    ref_v = rng.randint(0, 256, ref_u.shape)
    slots = [1, 3][:n_slots]
    m = tmc.MC_MV_MAX
    far = edge == "far"
    n_fresh = 0 if far else n_extra
    mvs = set()
    while len(mvs) < n_main + n_fresh:
        mvs.add(tuple(int(v) for v in rng.randint(-64, 65, 2)))
    mvs = sorted(mvs, key=lambda v: rng.rand())
    if edge is True:
        mvs[:4] = [(m, m), (-m, -m), (m, -m), (-m, m)]
    # triple k: (slot, mvy, mvx), the slots taken in turn
    trip = np.array([(slots[k % n_slots], *v) for k, v in enumerate(mvs)])
    intra = np.arange(n) % 40 == 39
    intra[:n_main] = False
    pick = np.concatenate([np.arange(min(n_main, n)),
                           rng.randint(0, n_main, max(n - n_main, 0))])
    if far:
        corners = np.unique([0, mb_w - 1, n - mb_w, n - 1])
        rest = np.setdiff1d(np.arange(n_main, n), corners)
        spots = np.concatenate([corners, rng.choice(
            rest[~intra[rest]], n_extra - len(corners), replace=False)])
        intra[spots] = False
    else:
        spots = rng.choice(np.flatnonzero(~intra[n_main:]) + n_main,
                           n_extra, replace=False)
        pick[spots] = n_main + np.arange(n_extra)
    t = trip[pick]                                      # [n, 3]
    ref_slot = np.repeat(t[:, :1], 16, 1).astype(np.int32)
    mv = np.repeat(t[:, None, [2, 1]], 16, 1).astype(np.int16)
    if far:
        cells = (len(spots), 16, 2)
        sign = rng.choice([-1, 1], cells)
        longer = sign * rng.randint(m + 1, 201, cells)
        reach = 4 * (W + 2 * pad)
        clipped = sign * rng.randint(m + 1, reach + 1, cells)
        mv[spots] = np.where(rng.rand(len(spots), 16, 1) < 0.5, longer,
                             clipped)
        ref_slot[spots] = rng.randint(0, R, (len(spots), 16))
    ref_slot[intra] = -1
    mv[intra] = 0
    plan = tmc.mc_fast_plan(mb_w, mb_h, ref_slot, mv.astype(np.int32), pad)
    if not plan["mc_fast"]:
        raise ValueError("the plan does not serve this frame")
    p = planes_to_torch(dict(plan, mv=mv, ref_slot=ref_slot), device)
    rings = [torch.as_tensor(a.astype(np.uint8), device=device)
             for a in (ref_y, ref_u, ref_v)]
    return (*rings, pad, p)


def _frames_by_hand(data, device):
    """Decode `data` by hand along TorchDecoder._decode_one and yield,
    before each frame is reconstructed, (frame, decoder, its numpy plane
    dict, the plane dict on `device`, mb_w, mb_h). The decode then goes
    on with the frame's full reconstruction, so each frame sees the
    rings a decode gives it."""
    from . import decoder_torch as dt
    dec = dt.TorchDecoder(data, device=device)
    for i, f in enumerate(dec.sym):
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        dec._prep_refs(mb_w, mb_h)
        planes_np, diags, has_intra, full = dec._prep_planes(f)
        p = dt.planes_to_torch(planes_np, dec.device)
        yield i, dec, planes_np, p, mb_w, mb_h
        Yw, Uw, Vw, ry, ru, rv = dt._residual_and_inter(
            mb_w, mb_h, p, dec.ref_y, dec.ref_u, dec.ref_v)
        if has_intra:
            scan = dt._intra_scan if full else dt._intra_scan_sparse
            Yw, Uw, Vw = scan(mb_w, mb_h, Yw, Uw, Vw, ry, ru, rv, p, diags)
        if dec._needs_deblock(f, planes_np["nnz"]):
            yuv = dt._deblock_crop(mb_w, mb_h, Yw, Uw, Vw, p)
        else:
            yuv = dt._crop(mb_w, mb_h, Yw, Uw, Vw)
        dec._finish_frame(f, *yuv, False)


def bucketed_mc_frames(data, device):
    """Decode `data` by hand (_frames_by_hand) and yield, before each P
    frame on the bucketed MC path is reconstructed, that frame's
    mc_bucketed arguments: (frame, ref_y, ref_u, ref_v, pad, p, mb_w,
    mb_h)."""
    from .decoder_torch import PAD
    for i, dec, planes_np, p, mb_w, mb_h in _frames_by_hand(data, device):
        if planes_np["mc_any"] and planes_np["mc_fast"]:
            yield i, dec.ref_y, dec.ref_u, dec.ref_v, PAD, p, mb_w, mb_h


def cells_mc_frames(data, device):
    """Decode `data` by hand (_frames_by_hand) and yield, before each P
    frame on the per-cell MC route is reconstructed (the plan does not
    serve it: mc_fast False), that frame's route arguments: (frame,
    mb_w, mb_h, p, ref_y, ref_u, ref_v), as decoder_torch._mc_cells takes
    them."""
    for i, dec, planes_np, p, mb_w, mb_h in _frames_by_hand(data, device):
        if planes_np["mc_any"] and not planes_np["mc_fast"]:
            yield i, mb_w, mb_h, p, dec.ref_y, dec.ref_u, dec.ref_v


def k11_plain(ref_y, ref_u, ref_v, pad, p, mb_w, mb_h):
    """K11's plain version, with ops/mc.mc_cells' arguments, on the
    rings' device: _mc_legacy_cells' tiles as planes (the per-cell route
    on the CPU, decoder_torch._mc_cells) with 0 on every cell whose
    ref_slot is below 0, as K11 writes them (K7 reads the prediction of no
    such cell)."""
    from .decoder_torch import _mc_legacy_cells, _tiles_to_plane
    tiles = _mc_legacy_cells(mb_w, mb_h, p, ref_y, ref_u, ref_v)
    inter = _tiles_to_plane((p["ref_slot"] >= 0).reshape(-1, 4, 4), mb_w,
                            mb_h, 4)
    out = []
    for t, s in zip(tiles, (16, 8, 8)):
        keep = inter.repeat_interleave(s // 4, 0).repeat_interleave(s // 4,
                                                                      1)
        out.append(torch.where(keep, _tiles_to_plane(t, mb_w, mb_h, s), 0))
    return tuple(out)


# K11's cases: (name, mb_w, mb_h, seed, options of random_cells_case).
# Every case sets the first 64 inter cells' MV fractions to the 64 chroma
# phases (and so the 16 luma ones); "far" sends a share of the cells far
# past the padded border (the iFullMV clip); WP weights every cell's luma
# and a random part of the chroma (a partial wp_cmask), with denominators
# -1 (off) to 7 and weights and offsets over int8; widths of 9, 11 and 13
# MBs, the walk deployment's 40x22 and 720p.
K11_CASES = [
    ("9x4 every phase, 4 slots", 9, 4, 0, dict()),
    ("9x4 far MVs", 9, 4, 1, dict(far=0.5)),
    ("9x4 WP, partial chroma mask", 9, 4, 2, dict(wp=True)),
    ("11x3 WP, far MVs, 19 slots", 11, 3, 3, dict(wp=True, far=0.3,
                                                   slots=19)),
    ("13x5 no intra MB", 13, 5, 4, dict(intra=0.0, far=0.1)),
    ("640x352 WP, far MVs", 40, 22, 5, dict(wp=True, far=0.1)),
    ("720p", 80, 45, 6, dict(far=0.05)),
]


def random_cells_case(mb_w, mb_h, seed, wp=False, far=0.0, intra=0.1,
                      slots=4, device="cpu"):
    """(ref_y, ref_u, ref_v, pad, p) for the per-cell MC route
    (decoder_torch._mc_cells, K11): uint8 noise rings of `slots` slots
    (pad 32) and a plane dict of ref_slot (int32 [n, 16], a slot of the
    whole ring per cell, -1 on a share `intra` of the MBs) and mv (int16
    [n, 16, 2]): |mv| <= 64 quarter-pels, but a share `far` of the cells
    MC_MV_MAX + 1 to 4 (W + 2 pad) quarter-pels per component, which the
    iFullMV clip pulls back into the padded planes; the first 64 inter
    cells that are not far take the 64 eighth-pel phases (mvx & 7, mvy &
    7). With `wp` the
    four WP planes as the symbol layer gives them: wp_luma, wp_cb, wp_cr
    int16 [n, 16, 3] (weight and offset -128..127, denominator -1 (off)
    to 7) and wp_cmask uint8 [n, 8, 8], about half its samples set. The
    plan keys mc_bucket, mc_fast (False) and mc_any make the dict one
    decoder_torch._inter_pred routes to the per-cell path."""
    from .decoder_torch import planes_to_torch
    from .ops import mc as tmc
    rng = np.random.RandomState(seed)
    pad = 32
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    ref_y = rng.randint(0, 256, (slots, H + 2 * pad, W + 2 * pad))
    ref_u = rng.randint(0, 256, (slots, H // 2 + pad, W // 2 + pad))
    ref_v = rng.randint(0, 256, ref_u.shape)
    ref_slot = rng.randint(0, slots, (n, 16)).astype(np.int32)
    mv = rng.randint(-64, 65, (n, 16, 2))
    is_far = rng.rand(n, 16, 1) < far
    if far:
        reach = 4 * (W + 2 * pad)
        sign = rng.choice([-1, 1], (n, 16, 2))
        long_ = sign * rng.randint(tmc.MC_MV_MAX + 1, reach + 1, (n, 16, 2))
        mv = np.where(is_far, long_, mv)
    intra_mb = rng.rand(n) < intra
    ref_slot[intra_mb] = -1
    mv[intra_mb] = 0
    # short MVs never clip: the phases go to inter cells that are not far
    cells = np.flatnonzero((ref_slot >= 0).reshape(-1)
                           & ~is_far.reshape(-1))[:64]
    flat = mv.reshape(-1, 2)
    k = np.arange(len(cells))
    flat[cells, 0] = (flat[cells, 0] & ~7) | (k % 8)
    flat[cells, 1] = (flat[cells, 1] & ~7) | (k // 8)
    planes = {"ref_slot": ref_slot, "mv": mv.astype(np.int16),
              "mc_bucket": np.zeros((n, 16), np.uint8),
              "mc_fast": np.bool_(False),
              "mc_any": np.bool_(bool((ref_slot >= 0).any()))}
    if wp:
        for key in ("wp_luma", "wp_cb", "wp_cr"):
            q = np.stack([rng.randint(-128, 128, (n, 16)),
                          rng.randint(-128, 128, (n, 16)),
                          rng.randint(-1, 8, (n, 16))], -1)
            planes[key] = q.astype(np.int16)
        planes["wp_cmask"] = (rng.rand(n, 8, 8) < 0.5).astype(np.uint8)
    p = planes_to_torch(planes, device)
    rings = [torch.as_tensor(a.astype(np.uint8), device=device)
             for a in (ref_y, ref_u, ref_v)]
    return (*rings, pad, p)


def _coefficients(rng, shape, extremes):
    """Sparse int16 levels of `shape` [n, ...]: most 0, the rest small, and
    on every `extremes`-th MB (none with 0) levels at the int16 extremes,
    where JAX's int32 products in dequant wrap."""
    c = rng.randint(-24, 25, shape)
    c[rng.rand(*shape) < 0.6] = 0
    if extremes:
        big = np.zeros(shape, bool)
        big[::extremes] = rng.rand(*big[::extremes].shape) < 0.5
        c[big] = rng.choice([-32768, -32767, 32767], int(big.sum()))
    return c.astype(np.int16)


# K7's cases: (name, mb_w, mb_h, seed, options of random_residual_case).
# Every class, cbp and MC route; 8x8 transforms on and off, scaling
# matrices on and off, per-MB qp over 0..51 and fixed qp 0 and 51, chroma
# QP offsets of -12 and +12, coefficients at the int16 extremes, PCM MBs,
# MBs whose 16 ref_slot cells mix valid and invalid ones; 720p frames on
# every route, and one with transform8 on every MB but the I16 ones (K7's
# 8x8 warps everywhere); widths of 11 and 13 MBs, which K7's runs of 8
# MBs do not divide.
K7_CASES = [
    ("9x4 bucketed, t8, scaling", 9, 4, 0, dict(cqp=(-12, 12))),
    ("9x4 legacy MC, t8, flat", 9, 4, 1, dict(mc="legacy", scaling=False)),
    ("5x3 no MC, no luma8, no pcm", 5, 3, 2, dict(mc="none", t8=False,
                                                  pcm=False)),
    ("4x3 qp 0", 4, 3, 3, dict(qp=0, cqp=(12, -12))),
    ("4x3 qp 51", 4, 3, 4, dict(qp=51, cqp=(12, 12))),
    ("7x4 qp 51 extremes every MB", 7, 4, 5, dict(qp=51, extremes=1)),
    ("720p bucketed", 80, 45, 6, dict()),
    ("720p legacy MC, flat", 80, 45, 7, dict(mc="legacy", scaling=False,
                                             cqp=(-12, 12))),
    ("720p no MC", 80, 45, 8, dict(mc="none")),
    ("11x3 bucketed", 11, 3, 9, dict()),
    ("13x5 legacy MC, flat", 13, 5, 10, dict(mc="legacy", scaling=False)),
    ("720p t8 on every MB but I16", 80, 45, 11, dict(t8_all=True)),
]


def random_residual_case(mb_w, mb_h, seed, mc="bucketed", t8=True,
                         scaling=True, qp=None, cqp=None, pcm=True,
                         extremes=4, t8_all=False):
    """(planes, ref_y, ref_u, ref_v) of one frame for _residual_and_inter
    (and decoder_jax.recon_pre): a numpy plane dict with the keys of
    TorchDecoder._prep_planes that they read, in the symbol layer's
    dtypes, and uint8 noise rings of 4 slots (pad 32). Every class 0-8
    (PCM among them unless pcm=False, which also drops the pcm plane),
    every cbp_luma 0-15 and cbp_chroma 0-2, transform8 on a random half
    (t8=False: off everywhere and no luma8 plane; t8_all=True: on every
    MB that is not I16 and off on those), random scaling
    matrices (scaling=False: flat), per-MB qp over 0..51 with 0 and 51
    present (or the int qp everywhere), chroma QP offsets `cqp` (random
    in -12..12 by default), sparse levels with the int16 extremes on
    every `extremes`-th MB. Inter classes (3-7) read ring slots 1 and 3
    with 1..6 MVs of at most 64 quarter-pels (intra classes none), and a
    fifth of the MBs mixes valid and invalid ref_slot cells. The MC plan
    is mc_fast_plan's: mc "bucketed" (it must serve the frame), "legacy"
    (the general per-cell path: mc_fast False, as a weighted frame has
    it) or "none" (no valid cell: mc_any False)."""
    from .ops import mc as tmc
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    classes = np.arange(9) if pcm else np.arange(8)
    cls = rng.choice(classes, n)
    cls[rng.choice(n, min(n, len(classes)), replace=False)] = \
        classes[:min(n, len(classes))]
    qps = np.full(n, qp) if qp is not None else rng.randint(0, 52, n)
    if qp is None:
        qps[rng.choice(n, 2, replace=False)] = (0, 51)
    cbp_luma = rng.randint(0, 16, n)
    cbp_luma[:min(n, 16)] = np.arange(min(n, 16))
    if cqp is None:
        cqp = tuple(int(v) for v in rng.randint(-12, 13, 2))
    p = {
        "mb_class": cls.astype(np.uint8), "qp": qps.astype(np.uint8),
        "cbp_luma": cbp_luma.astype(np.uint8),
        "cbp_chroma": rng.randint(0, 3, n).astype(np.uint8),
        "transform8": (((rng.rand(n) < 0.5) | t8_all) & t8
                       & ~(t8_all & (cls == 1))).astype(np.uint8),
        "luma_ac": _coefficients(rng, (n, 16, 4, 4), extremes),
        "luma_dc": _coefficients(rng, (n, 4, 4), extremes),
        "chroma_ac": _coefficients(rng, (n, 8, 4, 4), extremes),
        "chroma_dc": _coefficients(rng, (n, 2, 2, 2), extremes),
        "use_scaling": np.bool_(scaling),
        "chroma_qp_offset": np.int32(cqp[0]),
        "second_chroma_qp_offset": np.int32(cqp[1]),
        "w4": [rng.randint(1, 256, (4, 4)).astype(np.int32)
               for _ in range(6)],
        "w8": [rng.randint(1, 256, (8, 8)).astype(np.int32)
               for _ in range(2)],
    }
    if t8:
        p["luma8"] = _coefficients(rng, (n, 4, 8, 8), extremes)
    if pcm:
        p["pcm"] = rng.randint(0, 256, (n, 384)).astype(np.uint8)
    mvs = rng.randint(-64, 65, (rng.randint(1, 7), 2))
    slots = np.array([1, 3])[rng.randint(0, 2, n)]
    ref_slot = np.where(cls[:, None] >= 3, slots[:, None], -1) \
        .repeat(16, 1)
    ref_slot[cls == 8] = -1
    mixed = rng.rand(n) < 0.2
    cells = rng.rand(n, 16) < 0.5
    ref_slot[mixed & (cls >= 3) & (cls < 8)] = np.where(
        cells[mixed & (cls >= 3) & (cls < 8)], -1, 1)
    ref_slot[mixed & ((cls < 3) | (cls == 8))] = np.where(
        cells[mixed & ((cls < 3) | (cls == 8))], 3, -1)
    if mc == "none":
        ref_slot[:] = -1
    mv = mvs[rng.randint(0, len(mvs), n)][:, None, :].repeat(16, 1)
    mv = np.where(ref_slot[..., None] >= 0, mv, 0).astype(np.int16)
    p["ref_slot"] = ref_slot.astype(np.int32)
    p["mv"] = mv
    plan = tmc.mc_fast_plan(mb_w, mb_h, p["ref_slot"], mv.astype(np.int32),
                            32)
    if mc == "bucketed" and not plan["mc_fast"]:
        raise ValueError("the plan does not serve this frame")
    if mc == "legacy":
        plan["mc_fast"] = np.bool_(False)
    plan["mc_any"] = np.bool_(bool((p["ref_slot"] >= 0).any()))
    p.update(plan)
    if mc != "none" and not p["mc_any"]:
        raise ValueError("no inter cell in the frame")
    rings = [rng.randint(0, 256, (4,) + s).astype(np.uint8)
             for s in ((H + 64, W + 64), (H // 2 + 32, W // 2 + 32),
                       (H // 2 + 32, W // 2 + 32))]
    return (p, *rings)


# K8's cases: (name, mb_w, mb_h, seed, references R, qp: an int or "mb" for
# a per-MB plane over 0..51 with 0 and 51 present, rd_lam). Clamped chroma
# windows on every side (the corner MBs' MVs), int32 sources, 720p frames;
# 7 and 13 MBs wide, frames whose MB count K8's CTAs of 8 MBs do not
# divide.
K8_CASES = [
    ("4x3 R 1 per-MB qp", 4, 3, 0, 1, "mb", None),
    ("4x3 R 2 per-MB qp rd_lam 144", 4, 3, 1, 2, "mb", 144),
    ("5x4 R 1 qp 0 rd_lam 144", 5, 4, 2, 1, 0, 144),
    ("5x4 R 2 qp 51", 5, 4, 3, 2, 51, None),
    ("9x4 R 2 qp 51 rd_lam 144", 9, 4, 4, 2, 51, 144),
    ("720p R 1", 80, 45, 5, 1, 28, None),
    ("720p R 2 per-MB qp rd_lam 144", 80, 45, 6, 2, "mb", 144),
    ("7x3 R 1 per-MB qp", 7, 3, 7, 1, "mb", None),
    ("13x2 R 2 qp 28 rd_lam 144", 13, 2, 8, 2, 28, 144),
]


def random_inter_residual_case(mb_w, mb_h, seed, R, qp, rd_lam,
                               device="cpu", dc_shift=False):
    """The inputs of encode_inter_mbs and of its residual half
    (encoder_torch.inter_residual) for one frame, as a dict of tensors on
    `device`: noise source planes Y, U, V (uint8; int32 on odd seeds) and
    R noise references with their padding (refY_s, refU_s, refV_s: noise
    in the padding too, so that a window clamped one sample off shows),
    per-MB qp
    (the int, or over 0..51 with 0 and 51 present) and qpc (CHROMA_QP of
    qp plus an offset in -12..12), rd_lam; and a subpel result to stand
    in for ops/me.subpel_quad's (mvqx, mvqy [4n] int32, best_sad [n],
    pred_q [4n, 8, 8]): quarter-pel MVs up to 64, and on the four corner
    MBs MVs that take the chroma window off the concatenated plane on
    every side (clamped), SADs that put use_intra both ways, a third of
    the MBs (luma and chroma) predicted exactly and a third to within 2;
    with the
    residual half's own inputs part, xoffC (a random reference per MB)
    and refcatU / refcatV. dc_shift=True adds 8..16 to the chroma of
    every other exactly predicted MB (clipped at 255): a residual whose
    only levels are chroma DC levels (at any qp), on which no_res
    hinges."""
    from .ops.mc import mc_chroma_mbs
    from .ref_np import CHROMA_QP
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    src = [rng.randint(0, 256, s) for s in ((H, W), (H // 2, W // 2),
                                            (H // 2, W // 2))]
    refs = [[rng.randint(0, 256, s) for s in (
        (H + 64, W + 64), (H // 2 + 32, W // 2 + 32),
        (H // 2 + 32, W // 2 + 32))] for _ in range(R)]
    qps = np.full(n, qp) if qp != "mb" else rng.randint(0, 52, n)
    if qp == "mb":
        qps[rng.choice(n, 2, replace=False)] = (0, 51)
    qpc = np.asarray(CHROMA_QP)[np.clip(qps + rng.randint(-12, 13, n), 0,
                                        51)]
    mv = rng.randint(-64, 65, (n, 4, 2))
    far = 4 * 8 * (W // 2 + 64)          # quarter-pels past any plane
    corners = (0, mb_w - 1, n - mb_w, n - 1)
    for c, (sx, sy) in zip(corners, ((-1, -1), (1, -1), (-1, 1), (1, 1))):
        mv[c] = (sx * rng.randint(far, 2 * far), sy * rng.randint(far,
                                                                  2 * far))
    proxy = rng.randint(0, 30000, n)
    best = proxy + rng.randint(-4096, 4097, n)
    ref_sel = rng.randint(0, R, n)
    dtype = np.int32 if seed % 2 else np.uint8
    refcat = [np.concatenate([r[k] for r in refs], 1) for k in (1, 2)]
    # a third of the MBs predicted exactly (no level: no_res) and a third
    # to within 2 (levels only at low qp), luma and chroma
    pred_q = rng.randint(0, 256, (n, 2, 8, 2, 8))
    keep = rng.choice(3, n)
    noise = rng.randint(-2, 3, (n, 16, 16)) * (keep == 1)[:, None, None]
    tiles = src[0].reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3) \
        .reshape(n, 2, 8, 2, 8)
    pred_q = np.where((keep < 2)[:, None, None, None, None],
                      np.clip(tiles + noise.reshape(n, 2, 8, 2, 8), 0, 255),
                      pred_q).transpose(0, 1, 3, 2, 4).reshape(4 * n, 8, 8)
    quad = np.arange(4)
    cy = ((np.arange(n) // mb_w) * 8)[:, None] + (quad // 2) * 4
    cx = ((np.arange(n) % mb_w) * 8 + ref_sel * (W // 2 + 32))[:, None] \
        + (quad % 2) * 4
    for k in (1, 2):
        pc = mc_chroma_mbs(torch.as_tensor(refcat[k - 1]), 16,
                           torch.as_tensor(cy.reshape(-1)),
                           torch.as_tensor(cx.reshape(-1)),
                           torch.as_tensor(mv[..., 0].reshape(-1)),
                           torch.as_tensor(mv[..., 1].reshape(-1)), size=4)
        pc = pc.numpy().reshape(mb_h, mb_w, 2, 2, 4, 4) \
            .transpose(0, 2, 4, 1, 3, 5).reshape(H // 2, W // 2)
        pick = np.kron((keep < 2).reshape(mb_h, mb_w), np.ones((8, 8), bool))
        src[k] = np.where(pick, np.clip(
            pc + np.kron((keep == 1).reshape(mb_h, mb_w), np.ones((8, 8)))
            * rng.randint(-2, 3, pc.shape), 0, 255), src[k])
    if dc_shift:
        exact = np.flatnonzero(keep == 0)[::2]
        shift = np.zeros(n, np.int64)
        shift[exact] = rng.randint(8, 17, len(exact))
        for k in (1, 2):
            src[k] = np.minimum(src[k] + np.kron(
                shift.reshape(mb_h, mb_w), np.ones((8, 8), np.int64)), 255)

    def T(a, dt=np.int32):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=device)

    refcat = [T(r, np.uint8) for r in refcat]
    return dict(
        Y=T(src[0], dtype), U=T(src[1], dtype), V=T(src[2], dtype),
        refY_s=T(np.stack([r[0] for r in refs]), np.uint8),
        refU_s=T(np.stack([r[1] for r in refs]), np.uint8),
        refV_s=T(np.stack([r[2] for r in refs]), np.uint8),
        qp=T(qps), qpc=T(qpc), rd_lam=rd_lam,
        mvqx=T(mv[..., 0].reshape(-1)), mvqy=T(mv[..., 1].reshape(-1)),
        best_sad=T(np.maximum(best, 0)),
        pred_q=T(pred_q),
        part=T(rng.randint(0, 4, n)), xoffC=T(ref_sel * (W // 2 + 32)),
        refcatU=refcat[0], refcatV=refcat[1])


def inter_residual_args(case):
    """The arguments of inter_residual (after mb_w, mb_h) in a
    random_inter_residual_case."""
    return tuple(case[k] for k in (
        "Y", "U", "V", "pred_q", "mvqx", "mvqy", "best_sad", "part",
        "refcatU", "refcatV", "xoffC", "qp", "qpc", "rd_lam"))


class HeldToPlain:
    """Within `with HeldToPlain(module, name, plain) as held:` every call of
    the kernel wrapper module.<name> also runs `plain` on the same
    arguments and holds each result to it (dtype and torch.equal);
    held.calls counts the calls, held.max_abs_err the largest difference
    and held.bad the calls that differed (a wrapper may return one tensor
    or a tuple of them); held.kept holds copies of the first `keep` calls'
    arguments. The wrapper's launches still count on
    it. Comparing costs the plain version's time, so a timed
    run goes without it."""

    def __init__(self, module, name, plain, keep=0):
        self.module, self.name, self.plain = module, name, plain
        self.calls, self.max_abs_err, self.bad = 0, 0, []
        self.keep, self.kept = keep, []

    def __enter__(self):
        wrapper = getattr(self.module, self.name)

        def held(*args):
            if len(self.kept) < self.keep:
                self.kept.append(tuple(a.clone() if torch.is_tensor(a)
                                       else a for a in args))
            got = wrapper(*args)
            want = self.plain(*args)
            one = torch.is_tensor(got)
            got, want = ((got,), (want,)) if one else (got, want)
            err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs()
                          .max().item()) if g.numel() else 0
                      for g, w in zip(got, want))
            self.max_abs_err = max(self.max_abs_err, err)
            if err or not all(g.dtype == w.dtype and torch.equal(g, w)
                              for g, w in zip(got, want)):
                self.bad.append(self.calls)
            self.calls += 1
            return got[0] if one else got

        held.launches = 0          # count_launch looks the wrapper up by name
        self.wrapper, self.held = wrapper, held
        setattr(self.module, self.name, held)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.wrapper)
        self.wrapper.launches += self.held.launches
        return False


def residual_frames(data, device):
    """Decode `data` by hand (_frames_by_hand) and yield, before each frame
    is reconstructed, the arguments of its residual reconstruction
    (decoder_torch._residual_recon, K7): (frame, mb_w, mb_h, p, pred_y,
    pred_u, pred_v), pred_* None on a frame without inter cells."""
    from .decoder_torch import _inter_pred
    for i, dec, _, p, mb_w, mb_h in _frames_by_hand(data, device):
        pred = _inter_pred(mb_w, mb_h, p, dec.ref_y, dec.ref_u, dec.ref_v)
        yield (i, mb_w, mb_h, p, *(pred or (None,) * 3))
