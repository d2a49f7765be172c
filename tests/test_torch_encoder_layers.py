"""TorchEncoder's reference structures and slice caps against JaxEncoder on
the CPU: the recipes of tests/test_encoder_jax.py for temporal layers 2,
hierarchical P with 4 layers and with 3 layers and a GOP, long-term
references with recovery after a loss (and the recipe whose mark
exposes a fault of the reference, pinned), and parameter-set ids, all
at 64x48. Size-capped slices are in tests/test_torch_encoder_slices.py. Every frame's bytes and recon equal JaxEncoder's,
and the port's decoder decodes the port's bytes as NpDecoder does
(tests/test_torch_encoder.py::assert_stream_exact); streams with frames
dropped decode to the same pictures."""
import numpy as np

from losslessh264_tpu import decoder_np
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.cases import moving_frames

from test_torch_encoder import assert_stream_exact, encode_both, eq

tnative.load()


def _nals(data):
    """The NAL units of an Annex-B stream, each with its 4-byte start code
    (JaxEncoder writes 4-byte start codes)."""
    out, i = [], 0
    while True:
        j = data.find(b"\x00\x00\x00\x01", i + 1)
        out.append(data[i:j if j > 0 else len(data)])
        if j < 0:
            return out
        i = j


def _decode(data):
    return [tuple(a.numpy() for a in yuv) for yuv in
            dt.TorchDecoder(data, device="cpu",
                            error_concealment=False).frames()]


def _same(a, b, what=""):
    for x, y, pl in zip(a, b, "YUV"):
        eq(x, y, f"{what} {pl}")


def _pan_noise(n, seed, W=64, H=48, size=(120, 120)):
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, size).astype(np.uint8)
    return [(np.ascontiguousarray(bg[i * 2:i * 2 + H, i * 3:i * 3 + W]),
             np.full((H // 2, W // 2), 100, np.uint8),
             np.full((H // 2, W // 2), 200, np.uint8)) for i in range(n)]


def test_temporal_layers_2():
    """Odd frames are non-reference T1 frames: dropping them leaves a T0
    stream that decodes to the same pictures."""
    r = encode_both(64, 48, _pan_noise(6, 5), qp=28, temporal_layers=2)
    assert_stream_exact(r)
    assert r["is_ref"] == [True, False] * 3
    te = r["enc"][1]
    assert [e[:3] for e in te.encodes] == [("P", "fused", False)]
    data = b"".join(r["torch"])
    full = _decode(data)
    t0 = b"".join(n for n in _nals(data) if (n[4] >> 5) != 0)
    sub = _decode(t0)
    assert len(full) == 6 and len(sub) == 3
    for a, b in zip(full[::2], sub):
        _same(a, b, "T0 frame")


def test_hierarchical_4_layers():
    """Each frame predicts from its dyadic parent (RPLR where the parent
    is not the newest reference, MMCO drops of stale references); the T3
    frames are droppable."""
    r = encode_both(64, 48, moving_frames(10, seed=31), qp=30,
                    temporal_layers=4)
    assert_stream_exact(r)
    assert r["is_ref"] == [True, False] * 5
    data = b"".join(r["torch"])
    full = _decode(data)
    kept = b"".join(n for n in _nals(data)
                    if (n[4] >> 5) != 0 or (n[4] & 0x1F) not in (1, 5))
    sub = _decode(kept)
    assert len(sub) == 5
    for k, i in enumerate(range(0, 10, 2)):
        _same(sub[k], full[i], f"T0-T2 frame {i}")


def test_hierarchical_3_layers_gop():
    """IDRs every 6 frames reset the dyadic chain (tests/test_encoder_jax.py's
    recipe, at this file's 64x48)."""
    r = encode_both(64, 48, moving_frames(9, seed=32), qp=32,
                    temporal_layers=3, gop=6)
    assert_stream_exact(r)
    assert r["is_ref"] == [True, False, True, False, True, False,
                           True, False, True]


def test_param_id():
    """Parameter-set ids on the SPS, the PPS and every slice."""
    frames = moving_frames(3, seed=2)
    for pid in (1, 3):
        r = encode_both(64, 48, frames, qp=30, param_id=pid, cabac=pid == 3)
        assert_stream_exact(r)
        plain = et.TorchEncoder(64, 48, qp=30, cabac=pid == 3, device="cpu")
        assert r["torch"][0] != plain.encode_frame(*frames[0])


def test_long_term_reference():
    """mark_ltr() before frame 1 re-marks the LTR; recover_from_ltr()
    before frame 4 predicts frame 4 from it, so dropping frames 2-3
    leaves frames 4-6 unchanged."""
    r = encode_both(64, 48, _pan_noise(7, 11, size=(120, 140)),
                    calls={1: ["mark_ltr"], 4: ["recover_from_ltr"]},
                    qp=28, ltr=True)
    assert_stream_exact(r)
    nals = _nals(b"".join(r["torch"]))     # SPS, PPS, then a NAL a frame
    full = _decode(b"".join(nals))
    lossy = _decode(b"".join(nals[:4] + nals[6:]))
    assert len(full) == 7 and len(lossy) == 5
    for a, b in zip(full[4:], lossy[-3:]):
        _same(a, b, "after the loss")


def test_ltr_mark_follows_the_reference_fault():
    """JaxEncoder's recipe of tests/test_encoder_jax.py: mark_ltr() before
    frame 2, recover_from_ltr() before frame 5. The frame that mark_ltr
    turns into the long-term reference leaves frame 1 in the DPB as the
    short-term one, and the decoder's list puts that first, while the
    encoder predicts frames 3-4 from frame 2: both decoders' frames 3-4
    differ from the encoder's recon, until the recovery frame predicts
    from the LTR again (ROADMAP §3). The port follows the reference bit
    for bit, and its decoder decodes the bytes as NpDecoder does."""
    r = encode_both(64, 48, _pan_noise(7, 11, size=(120, 140)),
                    calls={2: ["mark_ltr"], 5: ["recover_from_ltr"]},
                    qp=28, ltr=True)
    for g, w in zip(r["torch"], r["jax"]):
        assert g == w
    for g, w in zip(r["torch_recon"], r["jax_recon"]):
        _same(g, w, "recon")
    data = b"".join(r["torch"])
    got = _decode(data)
    want = list(decoder_np.NpDecoder(data, error_concealment=False).frames())
    for g, w in zip(got, want):
        _same(g, w, "TorchDecoder vs NpDecoder")
    closed = [all((a == b).all() for a, b in zip(g, rec))
              for g, rec in zip(got, r["torch_recon"])]
    assert closed == [True, True, True, False, False, True, True]
    nals = _nals(data)
    lossy = _decode(b"".join(nals[:5] + nals[7:]))
    for a, b in zip(got[5:], lossy[-2:]):
        _same(a, b, "after the loss")
