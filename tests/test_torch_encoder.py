"""The torch port's encoder (losslessh264_tpu_torch/encoder_torch.py) is
byte-exact vs losslessh264_tpu.encoder_jax.JaxEncoder on the CPU:

- its device functions against the JAX ones on the same numpy inputs:
  the masked intra wavefront and the whole-frame inter analysis with one
  and two references, with and without the trellis-lite rounding;
- the pinned copies of the JAX package's tables, tile helpers and native
  writer binding against their originals;
- whole streams on the recipes of tests/test_encoder_jax.py (default,
  gop=2, cabac, intra_only, force_intra_frame, scene_cut on a cut):
  every frame's Annex-B bytes and recon planes equal JaxEncoder's, and
  the port's TorchDecoder decodes the port's bytes to the port's recon;
- continuing a JAX stream from its state (load_state), the encode verb
  of the CLI, the option combinations both encoders refuse, and the card
  requirement.
Half of the whole-stream recipes, load_state and the CLI are in
tests/test_torch_encoder_streams.py; the other options' recipes are in
tests/test_torch_encoder_modes.py, test_torch_encoder_partitions.py,
test_torch_encoder_rc.py, test_torch_encoder_aq.py and
test_torch_encoder_layers.py.

This is an integer codec: every comparison is exact."""
import hashlib
import json
import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_np
from losslessh264_tpu import encoder as jenc
from losslessh264_tpu import encoder_jax, ratectl
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_native
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch import ratectl as tratectl
from losslessh264_tpu_torch.cases import golden_encoder, moving_frames

# the shared native library, built once under the port's lock, and one
# torch thread per worker (see tests/test_torch_decoder.py)
tnative.load()
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def T(a):
    return torch.as_tensor(np.array(a))


def eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def idr_count(data):
    """The number of IDR slice NAL units (type 5) in an Annex-B stream."""
    n, i = 0, 0
    while True:
        i = data.find(b"\x00\x00\x01", i)
        if i < 0:
            return n
        n += (data[i + 3] & 0x1F) == 5
        i += 3


def encode_both(W, H, frames, force_at=(), calls=None, rc=None,
                stamps=None, **kw):
    """Encode `frames` with JaxEncoder and with TorchEncoder(device="cpu")
    under the same options; per frame both encoders' bytes and recon,
    whether the port's frame was a reference, and what it ran
    (TorchEncoder.encodes). calls: {frame: [method
    name, or a function of the encoder]} applied to both encoders before
    that frame; rc: a function of a ratectl module that makes one rate
    controller (each encoder gets its own, the port's from its copy);
    stamps: the frames' timestamp_ms."""
    je = encoder_jax.JaxEncoder(W, H, rc=rc and rc(ratectl), **kw)
    te = et.TorchEncoder(W, H, device="cpu", rc=rc and rc(tratectl), **kw)
    calls = {i: list(v) for i, v in (calls or {}).items()}
    for i in force_at:
        calls.setdefault(i, []).append("force_intra_frame")
    out = {"jax": [], "torch": [], "jax_recon": [], "torch_recon": [],
           "is_ref": [], "encodes": [], "enc": (je, te)}
    for i, f in enumerate(frames):
        for c in calls.get(i, ()):
            for e in (je, te):
                c(e) if callable(c) else getattr(e, c)()
        ts = None if stamps is None else stamps[i]
        out["jax"].append(je.encode_frame(*f, timestamp_ms=ts))
        out["torch"].append(te.encode_frame(*f, timestamp_ms=ts))
        out["jax_recon"].append(je.recon)
        out["torch_recon"].append(te.recon)
        out["is_ref"].append(te._cur_is_ref)
        out["encodes"].append(te.encodes)
    return out


def assert_stream_exact(run):
    """Bytes and recon of every frame equal JaxEncoder's, and the port's
    CPU decoder decodes the port's bytes as the JAX package's NpDecoder
    does, frame by frame. The decoded frame equals the port's recon where
    the recon is that frame's picture: after a reference frame, and after
    a frame the rate controller dropped (b"", the previous picture); a
    non-reference frame's recon is the reference it predicted from."""
    assert len(run["torch"]) == len(run["jax"])
    for i, (g, w) in enumerate(zip(run["torch"], run["jax"])):
        assert g == w, f"frame {i}: {len(g)} bytes, JAX {len(w)}"
    for i, (g, w) in enumerate(zip(run["torch_recon"], run["jax_recon"])):
        for a, b, pl in zip(g, w, "YUV"):
            eq(a, b, f"frame {i} recon {pl}")
    data = b"".join(run["torch"])
    got = [tuple(a.numpy() for a in yuv) for yuv in
           dt.TorchDecoder(data, device="cpu",
                           error_concealment=False).frames()]
    want = list(decoder_np.NpDecoder(data, error_concealment=False).frames())
    assert len(got) == len(want) == sum(1 for d in run["torch"] if d)
    for k, (g, w) in enumerate(zip(got, want)):
        for a, b, pl in zip(g, w, "YUV"):
            eq(a, b, f"decoded frame {k} {pl}, TorchDecoder vs NpDecoder")
    k = -1
    for i, d in enumerate(run["torch"]):
        k += bool(d)
        if run["is_ref"][i] or not d:
            for a, b, pl in zip(got[k], run["torch_recon"][i], "YUV"):
                eq(a, b, f"frame {i} decoded {pl}")


def _cut_frames():
    """A smooth picture panning by 1 px per frame (every 8x8 block's
    zero-MV SAD stays under the high-motion threshold), a hard cut to
    noise at frame 2, and that noise with a few changed pixels after it:
    one scene cut, at frame 2."""
    yy, xx = np.mgrid[:48, :64]
    U = np.full((24, 32), 110, np.uint8)
    V = np.full((24, 32), 150, np.uint8)
    frames = [(((yy * 3 + (xx + i) * 2) % 200 + 20).astype(np.uint8), U, V)
              for i in range(2)]
    rng = np.random.RandomState(19)
    cut = rng.randint(0, 255, (48, 64)).astype(np.uint8)
    for i in range(3):
        Y = cut.copy()
        Y[rng.randint(0, 48, 20), rng.randint(0, 64, 20)] += 9 * i
        frames.append((Y, U, V))
    return frames


def _fallback_frames():
    """Translating noise whose frame 1 holds MBs of stripes and a flat MB
    that no reference predicts: that P frame falls back to intra (I4x4)
    on them, through the masked wavefront over the inter recon."""
    frames = moving_frames(4)
    Y1 = frames[1][0].copy()
    yy, xx = np.mgrid[:16, :32]
    Y1[16:32, 16:48] = ((xx % 8) < 4) * 40 + 60
    Y1[32:48, 0:16] = 60
    frames[1] = (Y1, *frames[1][1:])
    return frames


RECIPES = {
    "default": lambda: (moving_frames(4), (), dict(qp=26)),
    "p_intra": lambda: (_fallback_frames(), (), dict(qp=26)),
    "p_intra_slices": lambda: (_fallback_frames(), (), dict(qp=26,
                                                            slices=2)),
    "gop2": lambda: (moving_frames(5), (), dict(qp=28, gop=2)),
    "cabac": lambda: (moving_frames(4), (), dict(qp=26, cabac=True)),
    "intra_only": lambda: (moving_frames(3), (), dict(qp=26,
                                                      intra_only=True)),
    "force_intra": lambda: (moving_frames(6, seed=21), (3,), dict(qp=30)),
    "scene_cut": lambda: (_cut_frames(), (), dict(qp=28, scene_cut=True)),
}
_RUNS = {}


def run(name):
    if name not in _RUNS:
        frames, force_at, kw = RECIPES[name]()
        _RUNS[name] = encode_both(64, 48, frames, force_at, **kw)
    return _RUNS[name]


# ---------------------------------------------------------------------------
# pinned tables and helpers
# ---------------------------------------------------------------------------
def test_pinned_tables():
    eq(et.LAMBDA, encoder_jax.LAMBDA)
    eq(et.FLAT4, encoder_jax.FLAT4)
    eq(et._CELL_PART8, encoder_jax._CELL_PART8)
    eq(et.BLK, encoder_jax.BLK)
    eq(et._I4_TR_KIND, encoder_jax._I4_TR_KIND)
    assert (et.BIG, et.PAD, et.WPAD) == (encoder_jax.BIG, encoder_jax.PAD,
                                         encoder_jax.WPAD)
    assert (tratectl.SCENE_IDC_NONE, tratectl.SCENE_IDC_MEDIUM,
            tratectl.SCENE_IDC_LARGE) == (
        ratectl.SCENE_IDC_NONE, ratectl.SCENE_IDC_MEDIUM,
        ratectl.SCENE_IDC_LARGE)
    for mb_w, mb_h in ((4, 3), (1, 5), (7, 1), (80, 45)):
        eq(et.diagonals(mb_w, mb_h), encoder_jax._diagonals(mb_w, mb_h))


def test_tile_helpers():
    rng = np.random.default_rng(1)
    plane = rng.integers(0, 256, (48, 64)).astype(np.int32)
    tiles = encoder_jax._mb_tiles(jnp.asarray(plane), 3, 4, 16)
    eq(et._plane_to_tiles(T(plane), 4, 3, 16), tiles)
    eq(et._tiles_to_plane(T(tiles), 4, 3, 16),
       encoder_jax._tiles_to_plane(tiles, 3, 4, 16))
    t16 = rng.integers(-99, 99, (5, 16, 16)).astype(np.int32)
    t8 = rng.integers(-99, 99, (5, 8, 8)).astype(np.int32)
    eq(et._blocks16(T(t16)), encoder_jax._blocks16(t16))
    eq(et._blocks4(T(t8)), encoder_jax._blocks4(t8))
    eq(et._assemble16(et._blocks16(T(t16))), t16)
    eq(et._assemble8(et._blocks4(T(t8))), t8)
    b16 = rng.integers(-99, 99, (5, 16, 4, 4)).astype(np.int32)
    eq(et._assemble16(T(b16)), encoder_jax._assemble16(b16))
    eq(et._assemble8(T(b16[:, :4])), encoder_jax._assemble8(b16[:, :4]))


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mask,slices", [("all", 1), ("half", 1),
                                         ("half", 2), ("corner", 3)])
def test_intra_wavefront(mask, slices):
    """A 4x3-MB frame; on the masked cases the MBs that are not intra keep
    their inter tiles, and the intra MBs predict from them."""
    mb_w, mb_h = 4, 3
    n = mb_w * mb_h
    rng = np.random.default_rng(len(mask) + slices)
    yy, xx = np.mgrid[:48, :64]
    srcY = ((yy * 5 + xx * 3) % 256).astype(np.uint8)
    srcY[16:32] = rng.integers(0, 256, (16, 64))       # a noisy MB row
    srcY[32:48, 16:48] = 140                           # flat MBs: I16
    srcU = rng.integers(90, 110, (24, 32)).astype(np.uint8)
    srcV = ((yy[:24, :32] * 7) % 256).astype(np.uint8)
    is_intra = {"all": np.ones(n, bool),
                "half": rng.integers(0, 2, n).astype(bool),
                "corner": np.arange(n) % 5 == 0}[mask]
    inter = [rng.integers(0, 256, (n, t, t)).astype(np.int32)
             * (~is_intra)[:, None, None] for t in (16, 8, 8)]
    qp = rng.integers(20, 40, n).astype(np.int32)
    qpc = np.asarray(et.CHROMA_QP)[qp].astype(np.int32)
    row_slice = (np.arange(mb_h) * slices // mb_h).astype(np.int32)
    want = encoder_jax.intra_wavefront(
        mb_w, mb_h, srcY, srcU, srcV, *inter, jnp.asarray(is_intra), qp,
        qpc, jnp.asarray(encoder_jax._diagonals(mb_w, mb_h)),
        jnp.asarray(row_slice))
    got = et.intra_wavefront(mb_w, mb_h, T(srcY), T(srcU), T(srcV),
                             *map(T, inter), is_intra, T(qp), T(qpc),
                             row_slice)
    names = ("i16_mode", "intra_cls", "i4_modes", "chroma_mode", "luma_dc",
             "luma_ac", "chroma_dc", "chroma_ac", "recY", "recU", "recV")
    for name, g, w in zip(names, got, want):
        eq(g, w, name)
    cls = np.asarray(got[1])[is_intra]
    if mask == "all":       # both luma classes occur
        assert (cls == 0).any() and (cls == 1).any()


def _inter_case(R, seed):
    """A 4x3-MB source moved from the newest reference, with a few MBs
    from the older one (R = 2) and two flat MBs that no reference
    predicts (intra fallback)."""
    rng = np.random.RandomState(seed)
    H, W = 48, 64
    bg = rng.randint(0, 255, (H + 40, W + 40)).astype(np.uint8)
    old = rng.randint(0, 255, (H, W)).astype(np.uint8)
    Y = np.ascontiguousarray(bg[5:5 + H, 7:7 + W])
    ref = np.ascontiguousarray(bg[6:6 + H, 9:9 + W])   # MV (-2, -1) px
    if R == 2:
        Y[16:32, 16:48] = old[16:32, 16:48]
    Y[0:16, 0:16] = 30
    Y[32:48, 48:64] = 220
    U = rng.randint(90, 110, (H // 2, W // 2)).astype(np.uint8)
    V = np.full((H // 2, W // 2), 140, np.uint8)
    refs = [(ref, np.roll(U, 1, 1), V)]
    if R == 2:
        refs.append((old, U, V))
    stacks = [np.stack([np.pad(r[k], et.PAD >> (k > 0), mode="edge")
                        for r in refs]) for k in range(3)]
    return Y, U, V, stacks


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("rd_lam", [None, 144])
def test_encode_inter_mbs(R, rd_lam):
    Y, U, V, stacks = _inter_case(R, 3 + R)
    n = 12
    qp = np.full(n, 30, np.int32)
    qpc = np.full(n, int(et.CHROMA_QP[30]), np.int32)
    want = encoder_jax.encode_inter_mbs(4, 3, 16, Y, U, V, *stacks, qp, qpc,
                                        rd_lam=rd_lam)
    got = et.encode_inter_mbs(4, 3, 16, T(Y), T(U), T(V), *map(T, stacks),
                              T(qp), T(qpc), rd_lam=rd_lam)
    names = ("mvx", "mvy", "use_intra", "part", "ref_sel", "mv8", "mvq",
             "luma_ac", "chroma_dc", "chroma_ac", "tile_y", "tile_u",
             "tile_v", "no_res")
    for name, g, w in zip(names, got, want):
        eq(g, w, name)
    use_intra, ref_sel, mvq = (np.asarray(got[k]) for k in (2, 4, 6))
    assert use_intra[0] and use_intra[n - 1]
    assert (mvq < 0).any()
    if R == 2:
        assert ref_sel.any()


# ---------------------------------------------------------------------------
# the native writer binding
# ---------------------------------------------------------------------------
def test_writer_binding_matches_original(monkeypatch):
    """Every write_frame and mv_preds call of a CABAC, two-slice,
    two-reference encode, repeated through losslessh264_tpu.encoder's
    _write_frame and JaxEncoder._mv_preds on the same arrays."""
    writes, preds = [], []
    real_write, real_preds = encoder_native.write_frame, \
        encoder_native.mv_preds

    def spy_write(*a, **k):
        out = real_write(*a, **k)
        writes.append((a, k, out))
        return out

    def spy_preds(*a, **k):
        out = real_preds(*a, **k)
        preds.append((a, k, out))
        return out

    monkeypatch.setattr(encoder_native, "write_frame", spy_write)
    monkeypatch.setattr(encoder_native, "mv_preds", spy_preds)
    kw = dict(qp=28, cabac=True, slices=2, refs=2)
    te = et.TorchEncoder(64, 48, device="cpu", **kw)
    for f in moving_frames(4):
        te.encode_frame(*f)
    assert len(writes) == 4 and len(preds) == 3
    jlib = jenc._cfg_lib()
    for a, k, out in writes:
        assert jenc._write_frame(jlib, *a[1:], **k) == out
    je = encoder_jax.JaxEncoder(64, 48, **kw)
    for a, k, out in preds:
        mb_class, mv, mv8, ref_plane = a[4:8]
        for g, w in zip(out, je._mv_preds(mb_class, mv, mv8, ref_plane)):
            eq(g, w)


# ---------------------------------------------------------------------------
# whole streams
# ---------------------------------------------------------------------------
# the other recipes' streams are in tests/test_torch_encoder_streams.py:
# two files, so that the tier-1 run's workers share the compilations
HERE = ("default", "p_intra", "p_intra_slices", "gop2")


@pytest.mark.parametrize("name", HERE)
def test_stream_matches_jax(name):
    check_recipe(name)


def check_recipe(name):
    """A recipe's stream is exact (assert_stream_exact), with its IDRs
    where the options put them, and the P frames' intra fallback."""
    r = run(name)
    assert_stream_exact(r)
    idrs = [idr_count(d) > 0 for d in r["torch"]]
    want_idrs = {"default": [1, 0, 0, 0], "p_intra": [1, 0, 0, 0],
                 "p_intra_slices": [1, 0, 0, 0], "gop2": [1, 0, 1, 0, 1],
                 "cabac": [1, 0, 0, 0], "intra_only": [1, 1, 1],
                 "force_intra": [1, 0, 0, 1, 0, 0],
                 "scene_cut": [1, 0, 1, 0, 0]}[name]
    assert idrs == [bool(v) for v in want_idrs]
    if name.startswith("p_intra"):     # I4x4 MBs in the P frame
        f1 = list(tnative.SymbolDecoder(b"".join(r["torch"])))[1]
        assert (f1["mb_class"] == 0).any()


def test_encode_yuv():
    """encode_yuv (encode_frames, one encode_frame per frame) writes the
    default recipe's JaxEncoder stream."""
    got = et.encode_yuv(moving_frames(4), 64, 48, qp=26, device="cpu")
    assert got == b"".join(run("default")["jax"])


INVALID = [
    dict(temporal_layers=5), dict(temporal_layers=0),
    dict(temporal_layers=3, ltr=True), dict(temporal_layers=4, aq=True),
    dict(temporal_layers=3, refs=2), dict(temporal_layers=4, gom_rc=True),
    dict(refs=2, ltr=True), dict(refs=2, aq=True), dict(refs=2, gom_rc=True),
    dict(refs=3), dict(slice_max_bytes=1200, slices=2),
    dict(width=63), dict(height=47)]


@pytest.mark.parametrize("opt", INVALID)
def test_invalid_options_raise(opt):
    """The port refuses exactly the combinations JaxEncoder asserts on."""
    kw = {"width": 64, "height": 48, **opt}
    with pytest.raises(AssertionError):
        encoder_jax.JaxEncoder(**kw)
    with pytest.raises(ValueError):
        et.TorchEncoder(device="cpu", **kw)


@pytest.mark.parametrize("method", ["mark_ltr", "recover_from_ltr"])
def test_ltr_calls_need_ltr(method):
    with pytest.raises(AssertionError):
        getattr(encoder_jax.JaxEncoder(64, 48), method)()
    with pytest.raises(ValueError):
        getattr(et.TorchEncoder(64, 48, device="cpu"), method)()


def test_cuda_device_needs_a_gpu():
    if torch.cuda.is_available():
        assert et.TorchEncoder(64, 48).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            et.TorchEncoder(64, 48)


def _synth720p_frames(n):
    with open(os.path.join(DATA, "synth720p.264"), "rb") as fh:
        data = fh.read()
    frames = []
    for yuv in dt.TorchDecoder(data, device="cpu").frames():
        frames.append(tuple(a.numpy() for a in yuv))
        if len(frames) == n:
            return frames


@pytest.mark.slow
@pytest.mark.parametrize("name", ["C", "D"])
def test_synth720p_golden_head_cd(name):
    """Configurations C and D of chip_smoke.py's encode phase, frames 0-1,
    on the CPU: the committed JAX golden (tools/gen_enc_golden.py)."""
    gold = json.load(open(os.path.join(DATA,
                                       "synth720p_enc_golden_cde.json")))
    cfg = gold[name]
    te = golden_encoder(cfg, 1280, 720, "cpu")
    for i, (f, g) in enumerate(zip(_synth720p_frames(2), cfg["frames"])):
        for call in cfg.get("calls", {}).get(str(i), ()):
            getattr(te, call)()
        out = te.encode_frame(*f)
        assert len(out) == g["bytes"]
        assert hashlib.sha256(out).hexdigest() == g["sha256"]
        assert zlib.crc32(b"".join(p.tobytes() for p in te.recon)) == \
            g["recon_crc32"]
        assert te._cur_is_ref == g["is_ref"]


@pytest.mark.slow
def test_synth720p_golden_head():
    """Configuration A of chip_smoke.py's encode phase, frames 0-1, on the
    CPU: the committed JaxEncoder golden (tools/gen_enc_golden.py)."""
    gold = json.load(open(os.path.join(DATA, "synth720p_enc_golden.json")))
    with open(os.path.join(DATA, "synth720p.264"), "rb") as fh:
        data = fh.read()
    frames = []
    for yuv in dt.TorchDecoder(data, device="cpu").frames():
        frames.append(tuple(a.numpy() for a in yuv))
        if len(frames) == 2:
            break
    te = et.TorchEncoder(1280, 720, device="cpu", **gold["A"]["kwargs"])
    for f, g in zip(frames, gold["A"]["frames"]):
        out = te.encode_frame(*f)
        assert len(out) == g["bytes"]
        assert hashlib.sha256(out).hexdigest() == g["sha256"]
        assert zlib.crc32(b"".join(p.tobytes() for p in te.recon)) == \
            g["recon_crc32"]
