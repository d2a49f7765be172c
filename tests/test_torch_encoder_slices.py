"""TorchEncoder's size-capped slices against JaxEncoder on the CPU: the
recipes of tests/test_dynslice.py (a 900-byte cap at 128x96, and a
tighter cap giving more slices) and 4 temporal layers with a slice cap
(configuration D of chip_smoke.py at 64x48). Every frame's bytes and recon equal JaxEncoder's, and
the port's decoder decodes the port's bytes as NpDecoder does
(tests/test_torch_encoder.py::assert_stream_exact)."""
import numpy as np

from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.cases import moving_frames

from test_torch_encoder import assert_stream_exact, encode_both

tnative.load()


def _nals(data):
    """The NAL units of an Annex-B stream, each with its 4-byte start
    code."""
    out, i = [], 0
    while True:
        j = data.find(b"\x00\x00\x00\x01", i + 1)
        out.append(data[i:j if j > 0 else len(data)])
        if j < 0:
            return out
        i = j


def _slice_frames(n, W, H, seed=5):
    """tests/test_dynslice.py's textured ramp moving 3 px per frame."""
    rng = np.random.RandomState(seed)
    pad = 48
    yy, xx = np.indices((H + pad, W + pad))
    sc = (((yy * 3 + xx * 2) // 3 + rng.randint(0, 30, (H + pad, W + pad)))
          % 256).astype(np.uint8)
    out = []
    for i in range(n):
        s = (i * 3) % 32
        out.append((np.ascontiguousarray(sc[s:s + H, s:s + W]),
                    np.ascontiguousarray(sc[:H // 2, :W // 2]),
                    np.ascontiguousarray(sc[1:H // 2 + 1, :W // 2])))
    return out


def _slice_sizes(chunk):
    return [len(n) - 4 for n in _nals(chunk) if (n[4] & 0x1F) in (1, 5)]


def test_size_capped_slices():
    """A 900-byte cap: slices stay near it after the first frame, and some
    frame splits."""
    cap = 900
    r = encode_both(128, 96, _slice_frames(6, 128, 96), qp=30,
                    slice_max_bytes=cap)
    assert_stream_exact(r)
    sizes = [_slice_sizes(c) for c in r["torch"]]
    assert any(len(s) >= 2 for s in sizes[1:])
    assert all(sz <= cap * 1.10 + 32 for s in sizes[1:] for sz in s)
    assert r["enc"][1].deblock_idc == 2


def test_tighter_cap_more_slices():
    n = {}
    for cap in (700, 2400):
        r = encode_both(128, 96, _slice_frames(3, 128, 96), qp=30,
                        slice_max_bytes=cap)
        assert_stream_exact(r)
        n[cap] = len(_slice_sizes(r["torch"][-1]))
    assert n[700] > n[2400]


def test_layers_with_slice_cap():
    """Configuration D of chip_smoke.py at 64x48: 4 temporal layers and a
    slice cap; a cap this tight forces re-encodes, which run from the
    same references."""
    r = encode_both(64, 48, moving_frames(6, seed=8), qp=28,
                    temporal_layers=4, slice_max_bytes=160)
    assert_stream_exact(r)
    assert any(len(_slice_sizes(c)) > 1 for c in r["torch"])
    assert any(len(e) == 2 for e in r["encodes"])
