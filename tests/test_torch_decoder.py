"""The torch port's decoder (losslessh264_tpu_torch/decoder_torch.py):
the decode verb of its CLI against NpDecoder, the port's independence of
the JAX package, and the card requirement; and the helpers that
test_torch_decoder_stages.py and test_torch_decoder_streams.py share.

- test_torch_decoder_stages.py holds the decoder stage by stage against
  the JAX stages (recon_pre, intra_pass, deblock_pass) fed the SAME
  numpy frame state, on real frames of walk_analog and of a tiny stream;
- test_torch_decoder_streams.py holds whole streams against NpDecoder
  (the numpy oracle, itself exact vs the reference decoder), against
  JaxDecoder, and against the committed NpDecoder CRCs of
  tests/data/synth720p_np_crc.json.

JAX reaches the Pallas half-pel kernel on every P frame, so the module
attribute losslessh264_tpu.ops.mc.halfpel_planes_pallas is swapped for
its plain twin halfpel_planes wherever JAX decodes."""
import functools
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_np
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
# other workers fail to open). test_torch_decoder_stages.py and
# test_torch_decoder_streams.py do the same.
tnative.load()
# One intra-op thread per test process: the tier-1 run starts several
# pytest workers on one host, and torch's default of a thread per core
# in each of them oversubscribes the cores (on an 8-core CPU, the 3-frame
# 720p decode of test_synth720p_head_matches_golden took ~15 s alone
# with one thread and ~290 s with the default beside five other workers).
torch.set_num_threads(1)

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


def tiny_frames():
    """64x48, 6 frames of noise translating by (2, 3) px per frame:
    uniform MVs, so the P frames take the bucketed MC path."""
    rng = np.random.RandomState(5)
    bg = rng.randint(0, 255, (160, 200)).astype(np.uint8)
    return [(np.ascontiguousarray(bg[i * 2:i * 2 + 48, i * 3:i * 3 + 64]),
             np.full((24, 32), 100, np.uint8),
             np.full((24, 32), 200, np.uint8)) for i in range(6)]


@functools.lru_cache(maxsize=None)
def tiny_stream_bytes():
    """tiny_frames() encoded at qp 28 by the port's TorchEncoder on the
    CPU. Its bytes are JaxEncoder's
    (test_torch_decoder_streams.py::test_tiny_stream_matches_jaxdecoder
    checks that), without a JAX compilation in every file that reads
    the stream."""
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    enc = TorchEncoder(64, 48, qp=28, device="cpu")
    return b"".join(enc.encode_frame(*f) for f in tiny_frames())


@pytest.fixture(scope="module")
def tiny_stream():
    return tiny_stream_bytes()


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
    """Every module of the port (the encoder's ratectl.py, processing.py
    and simulcast.py among them), and chip_smoke.py, imports neither jax
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
        "need = {'losslessh264_tpu_torch.' + m for m in ('ops.deblock', "
        "'ratectl', 'processing', 'simulcast', 'encoder_torch', 'encoder', "
        "'native', 'parse', 'checkpoint', 'graft_entry', 'parallel', "
        "'parallel.decode', 'parallel.gop')}; "
        "assert need <= set(mods), mods; "
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

