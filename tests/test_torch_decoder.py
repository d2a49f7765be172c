"""The torch port's decoder (losslessh264_tpu_torch/decoder_torch.py) is
frame-exact on the CPU:

- stage by stage against the JAX stages (recon_pre, intra_pass,
  deblock_pass) fed the SAME numpy frame state (plane dict and
  reference rings), on real frames of walk_analog and of a tiny stream
  encoded here with encoder_jax.JaxEncoder on translating noise;
- whole streams against NpDecoder (the numpy oracle, itself exact vs
  the reference decoder), against JaxDecoder, and against the committed
  NpDecoder CRCs of tests/data/synth720p_np_crc.json.

JAX reaches the Pallas half-pel kernel on every P frame, so the module
attribute losslessh264_tpu.ops.mc.halfpel_planes_pallas is swapped for
its plain twin halfpel_planes wherever JAX decodes."""
import json
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_jax, decoder_np
from losslessh264_tpu.ops import mc as jmc
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native as tnative

# Build the shared native library now, while the test workers collect:
# the port's loader builds under a file lock and checks again once it
# holds it, so exactly one worker runs `make -C native` and the others
# wait. Every worker collects this file before any test runs, so the
# library is whole and newer than its sources by then, and the JAX
# package's own loader, which builds without a lock, finds nothing to
# build (two of its builds at once leave a half-linked library that
# other workers fail to open).
tnative.load()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLD = json.load(open(os.path.join(DATA, "synth720p_np_crc.json")))


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _crc(yuv):
    return zlib.crc32(b"".join(np.asarray(p).tobytes() for p in yuv))


@pytest.fixture
def plain_pallas(monkeypatch):
    monkeypatch.setattr(jmc, "halfpel_planes_pallas", jmc.halfpel_planes)


@pytest.fixture(scope="module")
def tiny_stream():
    """64x48, 6 frames of noise translating by (2, 3) px per frame:
    uniform MVs, so the P frames take the bucketed MC path."""
    from losslessh264_tpu import encoder_jax
    rng = np.random.RandomState(5)
    bg = rng.randint(0, 255, (160, 200)).astype(np.uint8)
    enc = encoder_jax.JaxEncoder(64, 48, qp=28)
    data = b""
    for i in range(6):
        data += enc.encode_frame(
            np.ascontiguousarray(bg[i * 2:i * 2 + 48, i * 3:i * 3 + 64]),
            np.full((24, 32), 100, np.uint8),
            np.full((24, 32), 200, np.uint8))
    return data


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def _stage_parity(data, n_frames):
    """Per frame: the port's stages and the JAX stages on the same numpy
    plane dict and the same numpy reference rings. Returns the set of
    (has_intra, mc_fast, mc_any) the frames covered."""
    dec = dt.TorchDecoder(data, device="cpu")
    covered = set()
    for i, f in enumerate(dec.sym):
        if i == n_frames:
            break
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        dec._prep_refs(mb_w, mb_h)
        planes_np, has_intra = dec._prep_planes(f)
        covered.add((has_intra, bool(planes_np["mc_fast"]),
                     bool(planes_np["mc_any"])))
        ring = [r.numpy().copy() for r in (dec.ref_y, dec.ref_u, dec.ref_v)]
        jp = jax.device_put(planes_np)
        jout = decoder_jax.recon_pre(mb_w, mb_h, jp,
                                     *[jnp.asarray(r) for r in ring])
        p = dt.planes_to_torch(planes_np, "cpu")
        tout = dt._residual_and_inter(
            mb_w, mb_h, p, *[dt.ring_to_torch(r, "cpu") for r in ring])
        for g, w, name in zip(tout, jout, ("Yw", "Uw", "Vw", "res_y",
                                           "res_u", "res_v")):
            _eq(g, w, f"frame {i} residual_and_inter {name}")
        jw, tw = jout[:3], tout[:3]
        if has_intra:
            diags = dt.diagonals(mb_w, mb_h)
            jw = decoder_jax.intra_pass(mb_w, mb_h, *jout, jp,
                                        jnp.asarray(diags))
            tw = dt._intra_scan(mb_w, mb_h, *tout, p, diags)
            for g, w, name in zip(tw, jw, "YUV"):
                _eq(g, w, f"frame {i} intra {name}")
        jyuv = decoder_jax.deblock_pass(mb_w, mb_h, *jw, jp)
        tyuv = dt._deblock_crop(mb_w, mb_h, *tw, p)
        for g, w, name in zip(tyuv, jyuv, "YUV"):
            _eq(g, w, f"frame {i} deblock {name}")
        dec._finish_frame(f, *tyuv, False)
    return covered


def test_stages_tiny_stream(plain_pallas, tiny_stream):
    covered = _stage_parity(tiny_stream, 6)
    assert (True, False, False) in covered      # I frame
    assert any(c[1] for c in covered)            # bucketed MC


def test_stages_walk_analog(plain_pallas):
    covered = _stage_parity(_read("walk_analog.264"), 2)
    assert (True, False, False) in covered
    assert any(c[2] and not c[1] for c in covered)   # per-cell MC


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


def test_cli_decode(tmp_path, tiny_stream):
    src = tmp_path / "tiny.264"
    out = tmp_path / "tiny.yuv"
    src.write_bytes(tiny_stream)
    subprocess.run([sys.executable, "-m", "losslessh264_tpu_torch", "decode",
                    str(src), str(out), "--device", "cpu"], check=True,
                   cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    dec = decoder_np.NpDecoder(tiny_stream)
    want = b"".join(p.tobytes() for yuv in dec.frames()
                    for p in decoder_np.crop_yuv(yuv, dec.crop_px))
    assert out.read_bytes() == want


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports neither jax
    nor anything of the JAX package losslessh264_tpu."""
    code = (
        "import importlib, pkgutil, sys; "
        "import losslessh264_tpu_torch as pkg; "
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'losslessh264_tpu_torch.')]; "
        "[importlib.import_module(m) for m in mods]; "
        "import chip_smoke; "
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'losslessh264_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'losslessh264_tpu.'))]; "
        "assert not bad, bad; "
        "assert 'losslessh264_tpu_torch.ops.deblock' in mods, mods; "
        "print('ok', len(mods))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr


def test_cuda_device_needs_a_gpu():
    data = _read("walk_analog.264")
    if torch.cuda.is_available():
        assert dt.TorchDecoder(data, device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            dt.TorchDecoder(data, device="cuda")

