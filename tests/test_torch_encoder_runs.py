"""The port's batched P runs (encoder_torch._p_batch, TorchEncoder.
_dispatch_p_run / _drain_p_run / _write_p_packed / _batchable and
encode_frames with its writer thread) against the JAX package's
JaxEncoder.encode_frames(batch=...) and against per-frame encode_frame
calls: bytes and recon.

The JAX package is imported inside the CPU tests, not at the top: the
card's machine has no JAX, and the `cuda` twin at the end runs there
(`python -m pytest tests/test_torch_encoder_runs.py -m cuda`)."""
import numpy as np
import pytest
import torch

from losslessh264_tpu_torch import cases
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.encoder_torch import TorchEncoder

# the native library built under the port's lock while the workers
# collect (tests/test_torch_decoder.py says why); one intra-op thread
tnative.load()
torch.set_num_threads(1)


def run_frames(n=7, patch_at=4):
    """n frames of 64x48 noise translating by (2, 3) px per frame
    (cases.moving_frames); frame `patch_at` carries a bright noise MB
    that nothing predicts, so its P frame falls back to intra there."""
    frames = [tuple(p.copy() for p in f) for f in cases.moving_frames(n)]
    rng = np.random.RandomState(1)
    frames[patch_at][0][16:32, 16:32] = 235 + rng.randint(-15, 16, (16, 16))
    return frames


def same_recon(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def test_runs_match_jax(monkeypatch):
    """1 IDR + 6 P frames with batch=3: two runs, the second holding the
    intra-fallback MB. Bytes and recon equal JaxEncoder.encode_frames'
    (which called encoder_jax._p_batch twice: a wrapper counts it) and
    per-frame encode_frame calls'."""
    from losslessh264_tpu import encoder_jax
    frames = run_frames()
    calls = []
    orig = encoder_jax._p_batch

    def count(*a, **kw):
        calls.append(len(a[4]))
        return orig(*a, **kw)

    monkeypatch.setattr(encoder_jax, "_p_batch", count)
    enc = TorchEncoder(64, 48, qp=28, device="cpu")
    got = enc.encode_frames(frames, batch=3)
    assert [(kind, path) for kind, path, _, _ in enc.encodes] == \
        [("I", "fused")] + [("P", "run")] * 6
    assert [k for *_, k in enc.encodes[4:]] == [1, 0, 0]
    assert enc.prof["frames"] == 6
    jenc = encoder_jax.JaxEncoder(64, 48, qp=28)
    assert got == jenc.encode_frames(frames, batch=3)
    assert calls == [3, 3]
    assert same_recon(enc.recon, jenc.recon)
    one = TorchEncoder(64, 48, qp=28, device="cpu")
    assert got == [one.encode_frame(*f) for f in frames]
    assert same_recon(enc.recon, one.recon)


@pytest.mark.parametrize("kwargs,batch,idr_before", [
    ({"qp": 30, "gop": 4}, 2, None),            # gop ends runs
    ({"qp": 30, "cabac": True, "slices": 2}, 3, 5),   # forced IDR
    ({"qp": 30, "deblock": False, "trellis": True}, 3, None),
    ({"qp": 30, "denoise": True}, 5, None),      # a run, a tail of 3
    ({"qp": 30, "refs": 2}, 3, None),            # not batchable
])
def test_runs_equal_per_frame_encodes(kwargs, batch, idr_before):
    """encode_frames(batch) gives the bytes and recon of encode_frame
    calls across the options a run takes (gop, a forced IDR, CABAC and
    two slices, the filter off with trellis, denoise) and on a
    configuration that runs none (refs=2)."""
    frames = run_frames(9, patch_at=6)
    runs = TorchEncoder(64, 48, device="cpu", **kwargs)
    one = TorchEncoder(64, 48, device="cpu", **kwargs)
    got, want = [], []
    for i, f in enumerate(frames):
        if i == idr_before:
            one.force_intra_frame()
        want.append(one.encode_frame(*f))
    if idr_before is None:
        got = runs.encode_frames(frames, batch=batch)
    else:
        got = runs.encode_frames(frames[:idr_before], batch=batch)
        runs.force_intra_frame()
        got += runs.encode_frames(frames[idr_before:], batch=batch)
    assert got == want
    assert same_recon(runs.recon, one.recon)
    assert runs._batchable == (kwargs.get("refs", 1) == 1)
    assert (runs.prof["frames"] > 0) == runs._batchable


@pytest.mark.parametrize("kwargs", [
    {}, {"intra_only": True}, {"aq": True}, {"scene_cut": True},
    {"refs": 2}, {"temporal_layers": 2}, {"ltr": True}, {"bgd": True},
    {"scroll_me": True}, {"slice_max_bytes": 500}, {"denoise": True},
    {"cabac": True, "slices": 3},
])
def test_batchable_matches_jax(kwargs):
    from losslessh264_tpu.encoder_jax import JaxEncoder
    assert TorchEncoder(64, 48, device="cpu", **kwargs)._batchable == \
        JaxEncoder(64, 48, **kwargs)._batchable


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_runs_on_card(cuda_device):
    """encode_frames(batch=3) on the card gives the CPU path's bytes and
    recon, and the writer thread wrote every run frame."""
    frames = run_frames()
    want = TorchEncoder(64, 48, qp=28, device="cpu")
    enc = TorchEncoder(64, 48, qp=28, device=cuda_device)
    assert enc.encode_frames(frames, batch=3) == \
        want.encode_frames(frames, batch=3)
    assert same_recon(enc.recon, want.recon)
    assert enc.prof["frames"] == 6
