"""The port's spatial simulcast (losslessh264_tpu_torch/simulcast.py)
against losslessh264_tpu.simulcast on the CPU, on the recipes of
tests/test_simulcast.py at their sizes: every layer's bytes and recon
equal the JAX SimulcastEncoder's in every access unit, each layer stream
decodes on the port's TorchDecoder as on NpDecoder, and the port's
SimulcastDecoder (over TorchDecoder) gives the JAX SimulcastDecoder's
pictures. Also the pinned SEI byte functions, the per-MB mode decision and
the pixel helpers against their originals."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_np
from losslessh264_tpu import processing as jproc
from losslessh264_tpu import simulcast as jsim
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch import processing as tproc
from losslessh264_tpu_torch import simulcast as tsim

from test_torch_encoder import ROOT, eq

tnative.load()
torch.set_num_threads(1)


def _noise(n=5, W=96, H=64, seed=9):
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, (H + 32, W + 32)).astype(np.uint8)
    return [(np.ascontiguousarray(bg[i * 2:i * 2 + H, i * 3:i * 3 + W]),
             np.full((H // 2, W // 2), 90 + i, np.uint8),
             np.full((H // 2, W // 2), 170, np.uint8)) for i in range(n)]


def _gradient(n=4, W=96, H=64):
    yy, xx = np.mgrid[0:H, 0:W]
    return [(((xx * 2 + yy) // 2 + i * 3).astype(np.uint8),
             (xx // 2 + 64)[:H // 2, :W // 2].astype(np.uint8),
             (yy + 128)[:H // 2, :W // 2].astype(np.uint8))
            for i in range(n)]


def _checkerboard(n=3, W=96, H=64):
    yy, xx = np.mgrid[0:H, 0:W]
    board = (((yy // 16) + (xx // 16)) % 2 * 255).astype(np.uint8)
    return [(np.roll(board, i, axis=1),
             np.full((H // 2, W // 2), 60, np.uint8),
             np.ascontiguousarray(
                 ((xx[:H // 2, :W // 2] // 8 % 2) * 255).astype(np.uint8)))
            for i in range(n)]


def _tiles(n=3, W=96, H=64):
    yy, xx = np.mgrid[0:H, 0:W]
    return [(((((yy // 16) + ((xx + i * 16) // 16)) % 2) * 128 + 64)
             .astype(np.uint8),
             np.full((H // 2, W // 2), 96, np.uint8),
             np.full((H // 2, W // 2), 160, np.uint8)) for i in range(n)]


def _ramp(n=3, W=200, H=120):
    yy, xx = np.mgrid[0:H, 0:W]
    return [(((xx + yy + i * 2) // 2).astype(np.uint8),
             np.ascontiguousarray((xx[:H // 2, :W // 2] // 4 + 60)
                                  .astype(np.uint8)),
             np.full((H // 2, W // 2), 140, np.uint8)) for i in range(n)]


RECIPES = {
    "two_layers": (_noise, 96, 64, dict(spatial_layers=2, qp=30)),
    "three_layers": (lambda: _noise(3, 128, 64, seed=10), 128, 64,
                     dict(spatial_layers=3, qp=32)),
    "ilp_gradient": (_gradient, 96, 64,
                     dict(spatial_layers=2, qp=30, inter_layer=True)),
    "ilp_saturated": (_checkerboard, 96, 64,
                      dict(spatial_layers=2, qp=30, inter_layer=True)),
    "ilp_tiles": (_tiles, 96, 64,
                  dict(spatial_layers=2, qp=30, inter_layer=True)),
    "ilp_not_mb_aligned": (_ramp, 200, 120,
                           dict(spatial_layers=2, qp=30, inter_layer=True)),
}


# the recipes at 96x64 share JaxEncoder's compilations; the inter-layer
# ones are in tests/test_torch_simulcast_ilp.py, and the two other
# sizes' recipes in tests/test_torch_simulcast_3layers.py and
# tests/test_torch_simulcast_crop.py (files the tier-1 run's workers
# share, each under a few minutes)
HERE = ("two_layers",)


@pytest.mark.parametrize("name", HERE)
def test_simulcast_matches_jax(name):
    assert_simulcast_exact(name)


def assert_simulcast_exact(name):
    make, W, H, kw = RECIPES[name]
    frames = make()
    je = jsim.SimulcastEncoder(W, H, **kw)
    te = tsim.SimulcastEncoder(W, H, device="cpu", **kw)
    assert te.dims == je.dims
    L = len(te.dims)
    streams = [b""] * L
    for k, f in enumerate(frames):
        got = te.encode_frame_layers(*f)
        want = je.encode_frame_layers(*f)
        for li in range(L):
            assert got[li] == want[li], f"AU {k} layer {li}"
            for a, b in zip(te.encs[li].recon, je.encs[li].recon):
                eq(a, b, f"AU {k} layer {li} recon")
            streams[li] += got[li]
    for li, s in enumerate(streams):
        clean = tsim._split_ilp_seis(s)[0] if li else s
        ours = [tuple(a.numpy() for a in yuv) for yuv in
                dt.TorchDecoder(clean, device="cpu",
                                error_concealment=False).frames()]
        ref = list(decoder_np.NpDecoder(clean,
                                        error_concealment=False).frames())
        assert len(ours) == len(ref) == len(frames)
        for a, b in zip(ours, ref):
            for x, y in zip(a, b):
                eq(x, y, f"layer {li} decode")
    if kw.get("inter_layer"):
        ours = list(tsim.SimulcastDecoder(streams, error_concealment=False,
                                          device="cpu").frames())
        ref = list(jsim.SimulcastDecoder(streams,
                                         error_concealment=False).frames())
        assert len(ours) == len(ref) == len(frames)
        for a, b in zip(ours, ref):
            for x, y in zip(a, b):
                eq(x.numpy(), y, "SimulcastDecoder")
        assert ours[0][0].shape == (H, W)


def test_sei_functions_pinned():
    rng = np.random.RandomState(4)
    for n, au in ((12, 0), (40, 5), (300, 200), (1, 70000)):
        bits = rng.randint(0, 2, n).astype(bool)
        bits[:8] = False               # zero bytes: emulation prevention
        nal = tsim._sei_mask_nal(bits, au)
        assert nal == jsim._sei_mask_nal(bits, au)
        for raw in (nal, bytes(rng.randint(0, 4, 64).astype(np.uint8))):
            assert tsim._ebsp_escape(raw) == jsim._ebsp_escape(raw)
            assert tsim._ebsp_unescape(raw) == jsim._ebsp_unescape(raw)
        stream = (b"\x00\x00\x00\x01\x67abc" + nal + b"\x00\x00\x00\x01\x65"
                  + bytes(40) + b"\x01" + nal)
        assert tsim._split_ilp_seis(stream) == jsim._split_ilp_seis(stream)


def test_ilp_decide_and_helpers():
    """The cost-not-variance pair of tests/test_simulcast.py, random
    planes, and sizes that are not whole MBs."""
    H, W = 32, 32
    yy, xx = np.mgrid[0:H, 0:W]
    src_y = (((yy // 16) + (xx // 16)) % 2 * 128 + 64).astype(np.uint8)
    checker = ((yy + xx) % 2 * 48 - 24)
    flatc = np.full((H // 2, W // 2), 128, np.uint8)
    rng = np.random.RandomState(8)
    cases = [
        ((src_y, flatc, flatc),
         (np.clip(src_y.astype(np.int32) - checker, 0, 255)
          .astype(np.uint8), flatc, flatc)),
        ((src_y, flatc, flatc),
         (np.clip(src_y.astype(np.int32) - 2, 0, 255).astype(np.uint8),
          flatc, flatc)),
    ]
    for h, w in ((48, 64), (40, 56), (120, 200)):
        src = tuple(rng.randint(0, 256, s).astype(np.uint8)
                    for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
        pred = tuple(np.clip(p.astype(np.int32)
                             + rng.randint(-140, 140, p.shape), 0, 255)
                     .astype(np.uint8) for p in src)
        cases.append((src, pred))
        smooth = tuple(np.clip(p.astype(np.int32)
                               + rng.randint(-3, 3, p.shape), 0, 255)
                       .astype(np.uint8) for p in src)
        cases.append((src, smooth))

    def T(planes):
        return tuple(torch.as_tensor(p) for p in planes)

    seen = set()
    for src, pred in cases:
        want = jsim.SimulcastEncoder._ilp_decide(src, pred)
        got = tsim.SimulcastEncoder._ilp_decide(T(src), T(pred))
        eq(got, want, "mode plane")
        seen |= set(np.unique(want).tolist())
        for g, w in zip(tsim.SimulcastEncoder._ilp_mix(T(src), T(pred),
                                                       got),
                        jsim.SimulcastEncoder._ilp_mix(src, pred, want)):
            eq(g, w, "mix")
        for g, w in zip(tsim._ilp_combine(T(pred), T(src), got),
                        jsim._ilp_combine(pred, src, want)):
            eq(g, w, "combine")
        sy = jsim._pad_mb(src[0], 16).astype(np.int32)
        eq(tsim._satd_mb(torch.as_tensor(sy)), jsim._satd_mb(sy), "satd")
        eq(tsim._pad_mb(torch.as_tensor(src[1]), 8),
           jsim._pad_mb(src[1], 8), "pad")
        eq(tproc.upsample2x(torch.as_tensor(src[1])),
           jproc.upsample2x(src[1]), "upsample")
    assert seen == {False, True}


def test_invalid_layouts_raise():
    for kw in (dict(spatial_layers=5), dict(spatial_layers=0)):
        with pytest.raises(ValueError):
            tsim.SimulcastEncoder(96, 64, device="cpu", **kw)
    with pytest.raises(ValueError):
        tsim.SimulcastEncoder(100, 64, spatial_layers=3, device="cpu")
    with pytest.raises(ValueError):
        tsim.SimulcastEncoder(32, 32, spatial_layers=3, device="cpu")


def test_cli_encode_spatial_layers(tmp_path):
    """`encode --spatial-layers 2` writes the JAX SimulcastEncoder's
    interleaved access units."""
    frames = _noise(3)
    src, out = tmp_path / "in.yuv", tmp_path / "out.264"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    subprocess.run([sys.executable, "-m", "losslessh264_tpu_torch", "encode",
                    str(src), "96x64", str(out), "--qp", "30", "--gop", "2",
                    "--spatial-layers", "2", "--device", "cpu"],
                   check=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    je = jsim.SimulcastEncoder(96, 64, spatial_layers=2, qp=30, gop=2)
    assert out.read_bytes() == b"".join(je.encode_frame(*f) for f in frames)

