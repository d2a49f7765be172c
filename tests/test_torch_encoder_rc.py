"""TorchEncoder with rate control against JaxEncoder on the CPU: the
recipes of tests/test_processing.py (scene cut with RC) and tests/test_ratectl.py (a dropped frame advances
no state; a stream with dropped frames still decodes), and every
controller of ratectl.py driving a stream. Each encoder holds its own
controller (the port's from its pinned copy, losslessh264_tpu_torch/
ratectl.py). Every frame's bytes and recon equal JaxEncoder's, and the
port's decoder decodes the port's bytes as NpDecoder does
(tests/test_torch_encoder.py::assert_stream_exact)."""
import numpy as np
import pytest

from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.cases import moving_frames

from test_torch_encoder import assert_stream_exact, encode_both, idr_count

tnative.load()


def _synthetic_stream(n_frames, W, H, cut_at):
    """tests/test_ratectl.py's moving textured scene with a hard cut."""
    rng = np.random.RandomState(7)
    pad = 64
    sc1 = ((np.indices((H + pad, W + pad)).sum(0) * 3
            + rng.randint(0, 60, (H + pad, W + pad))) % 256).astype(np.uint8)
    sc2 = ((np.indices((H + pad, W + pad))[0] * 7
            + rng.randint(0, 90, (H + pad, W + pad))) % 256).astype(np.uint8)
    frames = []
    for i in range(n_frames):
        scene = sc1 if i < cut_at else sc2
        s = (i * 2) % 32
        frames.append((np.ascontiguousarray(scene[s:s + H, s:s + W]),
                       np.ascontiguousarray(scene[:H // 2, :W // 2]),
                       np.ascontiguousarray(scene[1:H // 2 + 1, :W // 2])))
    return frames


def test_scene_cut_and_rc():
    rng = np.random.RandomState(5)
    H, W = 48, 64
    a = rng.randint(0, 255, (H, W)).astype(np.uint8)
    b = rng.randint(0, 255, (H, W)).astype(np.uint8)
    U = np.full((H // 2, W // 2), 90, np.uint8)
    V = np.full((H // 2, W // 2), 160, np.uint8)
    frames = [(a, U, V)] * 3 + [(b, U, V)] * 2
    r = encode_both(W, H, frames, qp=30, scene_cut=True,
                    rc=lambda m: m.RateControl(200_000, 25, qp_init=30))
    assert_stream_exact(r)
    assert [idr_count(d) > 0 for d in r["torch"]] == [1, 0, 0, 1, 0]


def _cram(enc):
    enc.rc.buffer = enc.rc.skip_threshold * 10


def test_skip_advances_no_state():
    """TimestampRC drops frame 1 once its buffer is crammed; the long
    timestamp gap drains it for frame 2."""
    frames = _synthetic_stream(4, 64, 48, cut_at=99)
    r = encode_both(64, 48, frames, calls={1: [_cram]},
                    stamps=[0, 33, 100_000, 100_033],
                    rc=lambda m: m.TimestampRC(50_000, 30.0))
    assert r["torch"][1] == b"" and all(r["torch"][i] for i in (0, 2, 3))
    assert r["enc"][1].frame_idx == 3   # the dropped frame is not counted
    assert_stream_exact(r)


def test_skipped_stream_still_decodes():
    """RateControl's buffer skip, crammed before frame 2: the dropped
    frames leave consecutive frame_nums, and the stream decodes."""
    frames = _synthetic_stream(6, 64, 48, cut_at=99)
    r = encode_both(64, 48, frames, calls={2: [_cram]},
                    rc=lambda m: m.RateControl(30_000, 30.0, frame_skip=True,
                                               qp_init=40))
    assert r["torch"][2] == b"" and r["torch"][0]
    assert_stream_exact(r)


@pytest.mark.parametrize("kind", ["bitrate", "timestamp", "buffer", "screen"])
def test_controllers_drive_a_stream(kind):
    """Each rate controller picks every frame's QP over a stream with a
    scene cut; the buffer-based one is told of a late delivery."""
    frames = _synthetic_stream(5, 64, 48, cut_at=3)
    make = {
        "bitrate": lambda m: m.RateControl(60_000, 25.0, qp_init=32),
        "timestamp": lambda m: m.TimestampRC(60_000, 25.0, qp_init=32),
        "buffer": lambda m: m.BufferBasedRC(qp_init=30),
        "screen": lambda m: m.ScreenContentRC(60_000, 25.0, qp_init=30),
    }[kind]
    calls = ({2: [lambda e: e.rc.report_delivery(False)]}
             if kind == "buffer" else None)
    r = encode_both(64, 48, frames, rc=make, calls=calls,
                    stamps=[0, 40, 80, 200, 240])
    assert_stream_exact(r)
    assert len({len(d) for d in r["torch"]}) > 1


def test_rc_on_moving_noise_cabac():
    """RC with CABAC and a forced IDR (tick on an IDR mid-stream)."""
    r = encode_both(64, 48, moving_frames(5, seed=4), force_at=(3,),
                    cabac=True,
                    rc=lambda m: m.RateControl(80_000, 25.0, qp_init=30))
    assert_stream_exact(r)
