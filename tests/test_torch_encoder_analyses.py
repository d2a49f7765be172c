"""TorchEncoder against JaxEncoder on the CPU on frames of 64x96, the
size that the scroll detector and the per-row rate control need: the
recipes of tests/test_encoder_jax.py for GOM rate control and
scroll-recentred search, and every analysis option at once with RC and
LTR (configuration C of chip_smoke.py at 64x96). One size, so JaxEncoder
compiles once for the file. Every frame's bytes and recon equal
JaxEncoder's, and the port's decoder decodes the port's bytes as
NpDecoder does (tests/test_torch_encoder.py::assert_stream_exact)."""
import numpy as np

from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.cases import moving_frames

from test_torch_encoder import assert_stream_exact, encode_both

tnative.load()


def test_gom_rate_control():
    """Flat rows over textured rows: the per-row plane gives the textured
    rows the higher QP."""
    rng = np.random.RandomState(9)
    H, W = 96, 64
    frames = []
    for i in range(4):
        Y = np.zeros((H, W), np.uint8)
        Y[:H // 2] = 60 + i
        Y[H // 2:] = rng.randint(0, 255, (H // 2, W))
        frames.append((Y, np.full((H // 2, W // 2), 100, np.uint8),
                       np.full((H // 2, W // 2), 200, np.uint8)))
    r = encode_both(W, H, frames, qp=30, gom_rc=True,
                    rc=lambda m: m.RateControl(200_000, 25.0, qp_init=30))
    assert_stream_exact(r)
    rows = r["enc"][1]._qp_plane.reshape(6, 4)[:, 0]
    assert rows[5] > rows[0]


def test_scroll_me():
    """Content scrolling up by 7 rows per frame: the search recentres on
    the scroll and the MVs follow it."""
    rng = np.random.RandomState(11)
    H, W, dy = 96, 64, 7
    tall = rng.randint(0, 255, (H + 5 * dy, W)).astype(np.uint8)
    tallc = rng.randint(0, 255, (H // 2 + 4 * dy, W // 2)).astype(np.uint8)
    frames = [(np.ascontiguousarray(tall[i * dy:i * dy + H]),
               np.ascontiguousarray(tallc[i * dy // 2:i * dy // 2 + H // 2]),
               np.ascontiguousarray(
                   tallc[2 + i * dy // 2:2 + i * dy // 2 + H // 2]))
              for i in range(3)]
    r = encode_both(W, H, frames, qp=24, scroll_me=True)
    assert_stream_exact(r)
    je, te = r["enc"]
    assert te._scroll_dy == je._scroll_dy != 0
    mvy = list(tnative.SymbolDecoder(b"".join(r["torch"])))[-1]["mv"][
        :, :, 1].reshape(-1)
    assert abs(np.median(mvy[mvy != 0]) / 4.0 - dy) <= 2.5


def test_analyses_rc_and_ltr_together():
    """Configuration C of chip_smoke.py at 64x96 (the scroll detector
    needs more than 64 rows): RC, AQ, GOM RC, bgd, scroll ME, denoise and
    LTR, with mark_ltr before frame 2 and recover_from_ltr before frame
    3."""
    r = encode_both(64, 96, moving_frames(5, H=96, seed=3),
                    calls={2: ["mark_ltr"], 3: ["recover_from_ltr"]},
                    qp=28, aq=True, gom_rc=True, bgd=True, scroll_me=True,
                    denoise=True, ltr=True,
                    rc=lambda m: m.RateControl(400_000, 25.0, qp_init=28))
    assert_stream_exact(r)
    assert all(r["torch"])
