"""TorchEncoder (losslessh264_tpu_torch/encoder_torch.py) against
JaxEncoder on the CPU: the whole-stream recipes of
tests/test_encoder_jax.py that tests/test_torch_encoder.py leaves here
(CABAC, intra_only, force_intra_frame, scene_cut on a cut), continuing a
JAX stream from its state (load_state), and the encode verb of the CLI.
Every frame's bytes and recon equal JaxEncoder's, and the port's
TorchDecoder decodes the port's bytes to the port's recon
(tests/test_torch_encoder.py holds the helpers)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from losslessh264_tpu import encoder_jax
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch import native as tnative

from test_torch_encoder import ROOT, _cut_frames, check_recipe, eq, run

tnative.load()


@pytest.mark.parametrize("name", ["cabac", "intra_only", "force_intra",
                                  "scene_cut"])
def test_stream_matches_jax(name):
    check_recipe(name)


def test_load_state_continues_a_jax_stream():
    """Both encoders start frame 4 from JaxEncoder's state after frame 3
    (reference planes, counters, and scene_cut's previous source)."""
    frames = _cut_frames()
    je = encoder_jax.JaxEncoder(64, 48, qp=28, scene_cut=True)
    for f in frames[:4]:
        je.encode_frame(*f)
    te = et.TorchEncoder(64, 48, qp=28, scene_cut=True, device="cpu")
    te.load_state([np.asarray(p) for p in je.ref], None, je.frame_idx,
                  je._frame_num, je._idr_id, np.asarray(je._prev_src))
    assert te.encode_frame(*frames[4]) == je.encode_frame(*frames[4])
    for a, b in zip(te.recon, je.recon):
        eq(a, b)


def test_cli_encode(tmp_path):
    """`encode` with --gop 0 turns scene_cut on, as the JAX CLI does: the
    bytes equal the scene_cut recipe's JaxEncoder stream."""
    src = tmp_path / "in.yuv"
    out = tmp_path / "out.264"
    frames = _cut_frames()
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    subprocess.run([sys.executable, "-m", "losslessh264_tpu_torch", "encode",
                    str(src), "64x48", str(out), "--qp", "28", "--gop", "0",
                    "--device", "cpu"], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.read_bytes() == b"".join(run("scene_cut")["jax"])
