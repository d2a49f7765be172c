"""TorchEncoder's per-MB QP path and source analyses against JaxEncoder
on the CPU: the recipes of tests/test_encoder_jax.py for adaptive
quantization, background detection and denoise with a forced IDR, and
the T1+AQ fault of the reference, pinned, and the CLI's rate-control,
AQ, denoise and temporal-layer flags (the 64x96 recipes are in
tests/test_torch_encoder_analyses.py). Every frame's bytes and recon equal JaxEncoder's, and
the port's decoder decodes the port's bytes as NpDecoder does
(tests/test_torch_encoder.py::assert_stream_exact)."""
import os
import subprocess
import sys

import numpy as np

from losslessh264_tpu import decoder_np, native
from losslessh264_tpu import processing as jproc
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.cases import moving_frames

from test_torch_encoder import ROOT, assert_stream_exact, encode_both, eq, \
    idr_count

tnative.load()


def _half_flat(n=3, H=48, W=64):
    rng = np.random.RandomState(7)
    bg = rng.randint(0, 255, (H + 32, W + 32)).astype(np.uint8)
    bg[:, :W // 2 + 16] //= 8  # flat half + textured half
    return [(np.ascontiguousarray(bg[i * 2:i * 2 + H, i * 3:i * 3 + W]),
             np.full((H // 2, W // 2), 100, np.uint8),
             np.full((H // 2, W // 2), 200, np.uint8)) for i in range(n)]


def test_adaptive_quantization():
    r = encode_both(64, 48, _half_flat(), qp=30, aq=True)
    assert_stream_exact(r)
    assert len(np.unique(r["enc"][1]._qp_plane)) > 1
    assert all(path == "aq" for _, path, _, _ in r["enc"][1].encodes)


def test_background_detection():
    """tests/test_encoder_jax.py's static background with a moving
    foreground band, at 64x48 (the size of this file's other recipes)."""
    rng = np.random.RandomState(12)
    H, W = 48, 64
    bg = rng.randint(0, 255, (H, W)).astype(np.uint8)
    frames = []
    for i in range(3):
        Y = bg.copy()
        Y[16:32, 8 * i:8 * i + 16] = 255 - Y[16:32, 8 * i:8 * i + 16]
        frames.append((Y, np.full((24, 32), 100, np.uint8),
                       np.full((24, 32), 150, np.uint8)))
    r = encode_both(W, H, frames, qp=26, bgd=True)
    assert_stream_exact(r)
    assert (r["enc"][1]._qp_plane == 28).any()


def test_denoise_and_force_intra():
    r = encode_both(64, 48, moving_frames(6, seed=21), force_at=(3,),
                    qp=30, denoise=True)
    assert_stream_exact(r)
    assert [idr_count(d) for d in r["torch"]] == [1, 0, 0, 1, 0, 0]
    pip, st = native.compress(b"".join(r["torch"]), verify=False)
    assert native.decompress(pip)[0] == b"".join(r["torch"])


def test_denoise_is_the_prefilter():
    """denoise=True encodes what the flat-region filter produces: the
    bytes of a plain encode of the filtered source, here on a size that
    is not a whole number of MBs (the filter runs before the MB padding)."""
    rng = np.random.RandomState(22)
    for H, W in ((48, 64), (38, 50)):
        noisy = (np.full((H, W), 90) + rng.randint(-8, 9, (H, W))) \
            .astype(np.uint8)
        U = np.full((H // 2, W // 2), 100, np.uint8)
        V = np.full((H // 2, W // 2), 200, np.uint8)
        pre = np.asarray(jproc.denoise(noisy))
        assert not np.array_equal(pre, noisy)
        got = et.TorchEncoder(W, H, qp=30, denoise=True,
                              device="cpu").encode_frame(noisy, U, V)
        assert got == et.TorchEncoder(W, H, qp=30,
                                      device="cpu").encode_frame(pre, U, V)


def _pan(n=4, H=48, W=64):
    """A smooth gradient panning 1 px per frame."""
    yy, xx = np.mgrid[:H, :W]
    return [(((yy * 2 + (xx + i) * 3) % 180 + 30).astype(np.uint8),
             np.full((H // 2, W // 2), 110, np.uint8),
             np.full((H // 2, W // 2), 140, np.uint8)) for i in range(n)]


def test_t1_with_aq_follows_the_reference_fault():
    """temporal_layers=2 with aq: JaxEncoder's per-MB QP path deblocks
    self.ref after a non-reference T1 frame too, while self.ref is still
    the previous reference, so that reference is filtered twice and the
    decoder's frame 2 differs from the encoder's recon (ROADMAP §3). The
    port follows the reference bit for bit: equal bytes and recon, the
    same drift, and its decoder decodes the bytes as NpDecoder does. Once
    the JAX package is fixed, this test shows it."""
    r = encode_both(64, 48, _pan(), qp=40, temporal_layers=2, aq=True)
    for g, w in zip(r["torch"], r["jax"]):
        assert g == w
    for g, w in zip(r["torch_recon"], r["jax_recon"]):
        for a, b in zip(g, w):
            eq(a, b)
    data = b"".join(r["torch"])
    got = [tuple(a.numpy() for a in yuv) for yuv in
           dt.TorchDecoder(data, device="cpu",
                           error_concealment=False).frames()]
    want = list(decoder_np.NpDecoder(data, error_concealment=False).frames())
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            eq(a, b)
    assert r["is_ref"] == [True, False, True, False]
    eq(got[0][0], r["torch_recon"][0][0])
    assert (got[2][0] != r["torch_recon"][2][0]).any()
    # without aq the same recipe stays closed-loop
    assert_stream_exact(encode_both(64, 48, _pan(), qp=40,
                                    temporal_layers=2))


def test_cli_encode_rate_control_flags(tmp_path):
    """`encode --bitrate --fps --aq --denoise --temporal-layers` builds
    what the JAX CLI builds (RateControl(bitrate, fps, qp_init=--qp) with
    the GOM plane, scene cuts with --gop 0): the bytes of JaxEncoder with
    those options."""
    from losslessh264_tpu import encoder_jax, ratectl
    frames = moving_frames(4, seed=17)
    src, out = tmp_path / "in.yuv", tmp_path / "out.264"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    subprocess.run([sys.executable, "-m", "losslessh264_tpu_torch", "encode",
                    str(src), "64x48", str(out), "--qp", "30", "--bitrate",
                    "150000", "--fps", "30", "--aq", "--denoise",
                    "--temporal-layers", "2", "--device", "cpu"],
                   check=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    rc = ratectl.RateControl(150000, 30.0, qp_init=30)
    je = encoder_jax.JaxEncoder(64, 48, qp=30, gop=0, rc=rc, scene_cut=True,
                                aq=True, temporal_layers=2, gom_rc=True,
                                denoise=True)
    assert out.read_bytes() == b"".join(je.encode_frame(*f) for f in frames)
