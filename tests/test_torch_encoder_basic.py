"""The port's older encoder (losslessh264_tpu_torch/encoder.py) and its
device search (ops/me.full_search_sad) are exact against the JAX
package's (losslessh264_tpu/encoder.py, losslessh264_tpu/ops/me.py) on
the CPU: the window search on every block shape with forced ties, the
pinned per-MB helpers and ref_np's copies of the decoder's inverse
transforms on seeded blocks, and the bytes and recon of the recipes of
tests/test_encoder.py."""
import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_np as dn
from losslessh264_tpu import encoder as jenc
from losslessh264_tpu.ops import me as jme
from losslessh264_tpu_torch import encoder as tenc
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch import ref_np
from losslessh264_tpu_torch.ops import me as tme
from test_torch_me import T, _search_case, eq


def _block_case(kind, block, radius, seed, H=48, W=64, n=40):
    """Inputs of full_search_sad: blocks of `cur` at random block-aligned
    positions; the last two starts lie outside the padded plane (one
    negative), so JAX's dynamic_slice wraps and clamps them."""
    bh, bw = (block, block) if isinstance(block, int) else block
    cur, ref_pad = _search_case(kind, radius, seed, H, W)
    rng = np.random.default_rng(seed + 100)
    ys = rng.integers(0, H // bh, n) * bh
    xs = rng.integers(0, W // bw, n) * bw
    ys[-2:] = (H + 2 * radius, -5)
    xs[-2:] = (3, W + 40)
    blocks = np.stack([cur[y:y + bh, x:x + bw] if y + bh <= H and
                       x + bw <= W and y >= 0 else cur[:bh, :bw]
                       for y, x in zip(ys, xs)])
    return (blocks.astype(np.int32), ref_pad, ys.astype(np.int32),
            xs.astype(np.int32))


@pytest.mark.parametrize("kind,block,radius,seed", [
    ("random", 16, 16, 10), ("random", 8, 6, 11),
    ("periodic", (8, 16), 5, 12), ("random", (16, 8), 7, 13),
    ("flat", 16, 4, 14), ("periodic", 8, 6, 15)])
def test_full_search_sad(kind, block, radius, seed):
    """Every block shape; on the flat and periodic planes many
    displacements tie, and JAX's argmin keeps the first of the raster
    (dy, dx) order."""
    blocks, ref_pad, ys, xs = _block_case(kind, block, radius, seed)
    want = jme.full_search_sad(blocks, ref_pad, ys, xs, radius, block)
    got = tme.full_search_sad(T(blocks), T(ref_pad), T(ys), T(xs), radius,
                              block)
    for name, g, w in zip(("dy", "dx", "sad", "zero_sad"), got, want):
        eq(g, w, f"{kind} {block} {name}")
    if kind == "flat":
        assert (got[0] == -radius).all() and (got[1] == -radius).all()


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_ref_np_transform_copies():
    """ref_np's copies of decoder_np's per-block inverse transforms,
    dequantisation and plane prediction, on seeded blocks at every QP."""
    rng = np.random.default_rng(3)
    _same(ref_np.FLAT4, dn._FLAT4, "FLAT4")
    w_flat = ref_np.weights4(ref_np.FLAT4)
    for qp in range(52):
        w = (w_flat if qp % 2 else
             ref_np.weights4(rng.integers(1, 64, 16).astype(np.int32)))
        blk = rng.integers(-300, 300, (4, 4)).astype(np.int64)
        _same(ref_np.dequant4(blk, qp, w), dn.dequant4(blk, qp, w), "deq4")
        _same(ref_np.luma_dc_dequant(blk, qp, w),
              dn.luma_dc_dequant(blk, qp, w), "luma dc")
        _same(ref_np.chroma_dc_dequant(blk[:2, :2], qp, w),
              dn.chroma_dc_dequant(blk[:2, :2], qp, w), "chroma dc")
        _same(ref_np.hadamard4x4(blk), dn.hadamard4x4(blk), "hadamard")
        _same(ref_np.idct4x4(blk * 16), dn.idct4x4(blk * 16), "idct4x4")
    for size in (16, 8):
        for _ in range(20):
            left, top = rng.integers(0, 256, (2, size))
            tl = int(rng.integers(0, 256))
            _same(ref_np.plane_pred(left, top, tl, size, 0),
                  dn._plane_pred(left, top, tl, size, 0), f"plane {size}")


def test_pinned_helpers():
    """The forward transform and quantisers of the pinned per-MB loops."""
    rng = np.random.default_rng(4)
    _same(tenc._MF, jenc._MF, "MF")
    _same(tenc._ZZ4, jenc._ZZ4, "ZZ4")
    for qp in range(52):
        blk = rng.integers(-255, 256, (4, 4))
        W = tenc.fdct4x4(blk)
        _same(W, jenc.fdct4x4(blk), "fdct")
        for intra in (True, False):
            for skip_dc in (True, False):
                _same(tenc.quant4x4(W.copy(), qp, intra, skip_dc),
                      jenc.quant4x4(W.copy(), qp, intra, skip_dc),
                      f"quant4x4 {qp}")
        _same(tenc.fhadamard4(W), jenc.fhadamard4(W), "fhadamard")
        _same(tenc.quant_dc4(W * 3, qp), jenc.quant_dc4(W * 3, qp), "dc4")
        _same(tenc.quant_dc2(W[:2, :2], qp), jenc.quant_dc2(W[:2, :2], qp),
              "dc2")


def _test_frames(W=64, H=48, n=2):
    """The recipe of tests/test_encoder.py::_test_frames."""
    frames = []
    for i in range(n):
        ys, xs = np.mgrid[0:H, 0:W]
        Y = ((xs * 3 + ys * 2 + i * 17) % 256).astype(np.uint8)
        U = ((xs[: H // 2, : W // 2] + 64) % 256).astype(np.uint8)
        V = np.full((H // 2, W // 2), 200 - i, np.uint8)
        frames.append((Y, U, V))
    return frames


def test_intra_encoder_matches_jax():
    """tests/test_encoder.py:35: IntraEncoder(64, 48, qp=30), bytes and
    recon; and encode_yuv's all-intra streams at two QPs."""
    frames = _test_frames(n=1)
    te = tenc.IntraEncoder(64, 48, qp=30)
    je = jenc.IntraEncoder(64, 48, qp=30)
    assert te.encode_frame(*frames[0]) == je.encode_frame(*frames[0])
    for g, w in zip(te._recon, je._recon):
        _same(g, w, "recon")
    frames = _test_frames(n=3)
    for qp in (24, 28):
        assert (tenc.encode_yuv(frames, 64, 48, qp=qp)
                == jenc.encode_yuv(frames, 64, 48, qp=qp))


def _panning(seed, n, H=48, W=64):
    """tests/test_encoder.py:55-63: noise panning by (2, 3) px a frame."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, (H + 32, W + 32)).astype(np.uint8)
    return [(bg[i * 2:i * 2 + H, i * 3:i * 3 + W],
             np.full((H // 2, W // 2), 100 + i, np.uint8),
             np.full((H // 2, W // 2), 200, np.uint8)) for i in range(n)]


@pytest.mark.parametrize("recipe", ["panning", "panning_gop2", "static",
                                    "intra_fallback"])
def test_inter_encoder_matches_jax(recipe):
    """IPPP bytes and reference recon, frame by frame: the panning noise
    of tests/test_encoder.py:55 (qp 26; and with gop 2), the static
    scene of :84 whose P MBs all become P_Skip, and a scene cut whose P
    MBs fall back to I16."""
    H, W = 48, 64
    gop = 2 if recipe == "panning_gop2" else 0
    if recipe.startswith("panning"):
        frames = _panning(7, 4)
    elif recipe == "static":
        rng = np.random.RandomState(3)
        Y = rng.randint(0, 255, (H, W)).astype(np.uint8)
        frames = [(Y, np.full((H // 2, W // 2), 90, np.uint8),
                   np.full((H // 2, W // 2), 160, np.uint8))] * 2
    else:
        frames = _panning(7, 1) + [
            (np.full((H, W), v, np.uint8) if v else
             np.random.RandomState(9).randint(0, 255, (H, W))
             .astype(np.uint8),
             np.full((H // 2, W // 2), 30, np.uint8),
             np.full((H // 2, W // 2), 220, np.uint8)) for v in (0, 40)]
    te = tenc.Encoder(W, H, qp=26, gop=gop, device="cpu")
    je = jenc.Encoder(W, H, qp=26, gop=gop)
    stream = b""
    for i, f in enumerate(frames):
        got, want = te.encode_frame(*f), je.encode_frame(*f)
        assert got == want, f"frame {i}"
        for g, w in zip(te.ref, je.ref):
            _same(g, w, f"frame {i} ref")
        stream += got
    if recipe == "static":
        assert len(got) < 30
    if recipe == "intra_fallback":   # some P MBs are intra (classes 0-2)
        syms = list(tnative.SymbolDecoder(stream))
        assert any(np.isin(f["mb_class"], (0, 1, 2)).any()
                   for f in syms[1:])
    assert te.times["me"] > 0 and te.times["mb_loops"] > 0


def test_encoder_cuda_needs_a_gpu():
    if torch.cuda.is_available():
        assert tenc.Encoder(64, 48).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tenc.Encoder(64, 48)


def test_encode_frames_takes_batch():
    """JaxEncoder.encode_frames and the JAX SimulcastEncoder's take
    `batch`; the port's take it too, and their bytes are those of the
    calls without it (per-frame encodes, as JAX's docstring promises)."""
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    from losslessh264_tpu_torch.simulcast import SimulcastEncoder
    frames = _panning(5, 2)
    got = TorchEncoder(64, 48, qp=30, device="cpu").encode_frames(
        frames, batch=3)
    want = TorchEncoder(64, 48, qp=30, device="cpu").encode_frames(frames)
    assert len(got) == 2 and got == want
    # the simulcast layers all-intra: P frames add nothing here but time
    frames = frames + frames[:1]
    got, want = (SimulcastEncoder(64, 48, spatial_layers=2, qp=30,
                                  intra_only=True, device="cpu")
                 .encode_frames(frames, **kw) for kw in ({"batch": 3}, {}))
    assert len(got) == 3 and got == want
