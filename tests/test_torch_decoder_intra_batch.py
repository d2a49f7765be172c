"""The port's all-intra batch (decoder_torch.recon_intra_batch,
_store_refs_k and the run forming of TorchDecoder.frames()) against the
JAX package's (JaxDecoder, whose frames() sends a full run of 16
coefficient-sparse all-intra frames to recon_intra_batch) and NpDecoder,
on streams that the port's TorchEncoder writes in the test: IDRs of a
smooth pattern (cases.patch_frames) at qp 32, a few nonzero coefficients
per MB (JaxDecoder._batchable admits at most 32).

The JAX package is imported inside the CPU tests, not at the top: the
card's machine has no JAX, and the `cuda` twin at the end runs there
(`python -m pytest tests/test_torch_decoder_intra_batch.py -m cuda`)."""
import functools

import numpy as np
import pytest
import torch

from losslessh264_tpu_torch import cases
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.encoder_torch import TorchEncoder
from test_torch_decoder_runs import decode, same

# the native library built under the port's lock while the workers
# collect (tests/test_torch_decoder.py says why); one intra-op thread
tnative.load()
torch.set_num_threads(1)


def encode(width, height, idr):
    """The Annex-B bytes of cases.patch_frames(width, height) at qp 32,
    frame i an IDR where idr[i] is true, else a P frame."""
    enc = TorchEncoder(width, height, qp=32, device="cpu")
    out = b""
    for is_idr, f in zip(idr, cases.patch_frames(width, height,
                                                 [[]] * len(idr))):
        if is_idr:
            enc.force_intra_frame()
        out += enc.encode_frame(*f)
    return out


@functools.lru_cache(maxsize=None)
def intra_run():
    """16 IDRs at 64x48: one full run."""
    return encode(64, 48, [True] * 16)


@functools.lru_cache(maxsize=None)
def mixed_runs():
    """64x48: all-intra runs of 5, 2, 3 and 17 frames between P frames:
    a batch of 5, two frames one by one, a batch of 3, a full batch of
    16 and its leftover frame one by one."""
    idr = ([True] * 5 + [False] + [True] * 2 + [False] + [True] * 3
           + [False] + [True] * 17)
    return encode(64, 48, idr), idr


def test_intra_run_matches_jax_and_np(monkeypatch):
    """The 16-frame run: one batch of 16 in the port, one call of
    decoder_jax.recon_intra_batch in JAX (a wrapper counts it), and the
    same frames as both JaxDecoder and NpDecoder."""
    from losslessh264_tpu import decoder_jax, decoder_np
    from losslessh264_tpu.ops import mc as jmc
    monkeypatch.setattr(jmc, "halfpel_planes_pallas", jmc.halfpel_planes)
    calls = []
    orig = decoder_jax.recon_intra_batch

    def count(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(decoder_jax, "recon_intra_batch", count)
    data = intra_run()
    got, dec = decode(data, "cpu")
    assert dec.routes == [("batch", 16)] * 16
    assert same(got, list(decoder_np.NpDecoder(data).frames()))
    assert same(got, list(decoder_jax.JaxDecoder(data).frames()))
    assert calls == [1]


def test_runs_of_every_length_match_np():
    """Runs of 3-16 frames are batched (JAX would pad a flushed run of
    3-15 to 16 and scan it), shorter ones and the 17th frame of a run
    go one by one, P frames between them; every frame equals
    NpDecoder's."""
    from losslessh264_tpu import decoder_np
    data, idr = mixed_runs()
    got, dec = decode(data, "cpu")
    full = ("full", dt.diagonals(4, 3).shape[0])
    assert dec.routes == ([("batch", 5)] * 5 + [("none", 0)] + [full] * 2
                          + [("none", 0)] + [("batch", 3)] * 3
                          + [("none", 0)] + [("batch", 16)] * 16 + [full])
    assert len(got) == len(idr)
    assert same(got, list(decoder_np.NpDecoder(data).frames()))


def test_geometry_change_ends_a_run():
    """Three IDRs at 64x48, then three at 96x64 with new parameter sets:
    two batches of 3, each frame equal to NpDecoder's."""
    from losslessh264_tpu import decoder_np
    data = encode(64, 48, [True] * 3) + encode(96, 64, [True] * 3)
    got, dec = decode(data, "cpu")
    assert dec.routes == [("batch", 3)] * 6
    assert [f[0].shape for f in got] == [(48, 64)] * 3 + [(64, 96)] * 3
    assert same(got, list(decoder_np.NpDecoder(data).frames()))


def test_store_refs_k_equals_stores_in_order():
    """One batched store of a run equals the run's frames stored one by
    one in decode order, a slot that two frames share included."""
    rng = np.random.default_rng(3)
    H, W, R = 32, 48, 6
    Yk, Uk, Vk = (torch.as_tensor(rng.integers(0, 256, (5, h, w),
                                               dtype=np.uint8))
                  for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    slots = [4, 1, 4, 0, 2]
    rings = [torch.as_tensor(rng.integers(0, 256, (R, h + 2 * p, w + 2 * p),
                                          dtype=np.uint8))
             for h, w, p in ((H, W, dt.PAD), (H // 2, W // 2, dt.PAD // 2),
                             (H // 2, W // 2, dt.PAD // 2))]
    want = [r.clone() for r in rings]
    for k, s in enumerate(slots):
        dt._store_ref(*want, Yk[k], Uk[k], Vk[k], s)
    dt._store_refs_k(*rings, Yk, Uk, Vk, slots)
    assert all(torch.equal(a, b) for a, b in zip(rings, want))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_runs_on_card(cuda_device):
    """The card's decode of both streams equals the CPU path's, frame for
    frame and route for route."""
    for data in (intra_run(), mixed_runs()[0]):
        want, dec_cpu = decode(data, "cpu")
        got, dec = decode(data, cuda_device)
        assert dec.routes == dec_cpu.routes
        assert same(got, want)
