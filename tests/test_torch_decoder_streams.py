"""The torch port's decoder (losslessh264_tpu_torch/decoder_torch.py) is
frame-exact on the CPU on whole streams: against NpDecoder (the numpy
oracle, itself exact vs the reference decoder), against JaxDecoder, and
against the committed NpDecoder CRCs of tests/data/synth720p_np_crc.json.

JAX reaches the Pallas half-pel kernel on every P frame, so the module
attribute losslessh264_tpu.ops.mc.halfpel_planes_pallas is swapped for
its plain twin halfpel_planes wherever JAX decodes."""
import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_jax, decoder_np
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native as tnative

from test_torch_decoder import (GOLD, _crc, _read, plain_pallas,  # noqa: F401
                                tiny_frames, tiny_stream)

# the shared native library, built once under the port's lock, and one
# torch thread per worker (see tests/test_torch_decoder.py)
tnative.load()
torch.set_num_threads(1)


def _torch_frames(data, n=None, device="cpu"):
    out = []
    for yuv in dt.TorchDecoder(data, device=device).frames():
        out.append(tuple(a.cpu().numpy() for a in yuv))
        if n is not None and len(out) == n:
            break
    return out


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b, pl in zip(g, w, "YUV"):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"frame {i} plane {pl}")


def test_tiny_stream_matches_npdecoder(tiny_stream):
    want = list(decoder_np.NpDecoder(tiny_stream).frames())
    _assert_frames_equal(_torch_frames(tiny_stream), want)


def test_tiny_stream_matches_jaxdecoder(plain_pallas, tiny_stream):
    """The port's frames equal JaxDecoder's; and the stream, which the
    port's encoder writes here, has JaxEncoder's bytes."""
    from losslessh264_tpu import encoder_jax
    enc = encoder_jax.JaxEncoder(64, 48, qp=28)
    assert tiny_stream == b"".join(enc.encode_frame(*f)
                                   for f in tiny_frames())
    want = list(decoder_jax.JaxDecoder(tiny_stream).frames())
    _assert_frames_equal(_torch_frames(tiny_stream), want)


def test_walk_analog_matches_npdecoder():
    data = _read("walk_analog.264")
    want = []
    for yuv in decoder_np.NpDecoder(data).frames():
        want.append(yuv)
        if len(want) == 3:
            break
    _assert_frames_equal(_torch_frames(data, 3), want)


def test_synth720p_head_matches_golden():
    """Frames 0-2 at 1280x720: an IDR frame, then bucketed P frames."""
    gold = GOLD["synth720p"]["crc32"]
    got = _torch_frames(_read("synth720p.264"), 3)
    assert [_crc(f) for f in got] == gold[:3]


@pytest.mark.slow
@pytest.mark.parametrize("name,fname", [("synth720p", "synth720p.264"),
                                        ("walk_analog", "walk_analog.264")])
def test_stream_matches_golden(name, fname):
    gold = GOLD[name]
    got = _torch_frames(_read(fname), gold["frames"])
    assert [_crc(f) for f in got] == gold["crc32"]


def test_ltr_long_gap_matches_npdecoder():
    """The recipe of tests/test_decode_parity.py::
    test_jax_ltr_long_gap_eviction on the port: a long-term reference
    marked at frame 1 and recovered at frame 23, more frames back than
    the 18-slot reference ring holds, must survive eviction. The stream
    is committed (tools/gen_ltr_stream.py), so nothing is encoded here."""
    data = _read("ltr_gap_64x48.264")
    want = list(decoder_np.NpDecoder(data, error_concealment=False).frames())
    got = []
    for yuv in dt.TorchDecoder(data, device="cpu",
                               error_concealment=False).frames():
        got.append(tuple(a.cpu().numpy() for a in yuv))
    assert len(want) == 24
    _assert_frames_equal(got, want)
