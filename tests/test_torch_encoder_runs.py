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


# ---------------------------------------------------------------------------
# the encoder's contract with the benchmark's encode harness
# (bench_port/harness/encoding.py): the StageTimer names it reads, in
# order, the tracer's spans, the device steps each path calls, and the
# module attributes it wraps
# ---------------------------------------------------------------------------
# each path: (encoder options, frames encoded before the recorded call,
# the recorded call: ("frame", i) or ("run", first, last, batch))
CONTRACT_PATHS = {
    "fused_idr": ({}, 0, ("frame", 0)),
    "fused_p": ({}, 1, ("frame", 1)),
    "fused_p_intra": ({}, 4, ("frame", 4)),
    "aq_idr": ({"aq": True}, 0, ("frame", 0)),
    "aq_p": ({"aq": True}, 1, ("frame", 1)),
    "aq_p_intra": ({"aq": True}, 4, ("frame", 4)),
    "run": ({}, 0, ("run", 0, 7, 3)),
}
# the device steps that launch the kernels on the card (K1, K4, K5, K8,
# and K9 + K2 in _deblock_recon): (module, attribute)
CONTRACT_STEPS = (("ops.mc", "_halfpel_planes_u8"),
                  ("encoder_torch", "intra_wavefront"),
                  ("ops.me", "dense_full_search"),
                  ("encoder_torch", "inter_residual"),
                  ("encoder_torch", "_deblock_recon"))
_P_STEPS = ["dense_search", "subpel_k1", "residual"]
_DEBLOCK = ["deblock_edge_params", "deblock_k2"]
_AQ_DEBLOCK = ["deblock_host_planes", "deblock_upload"] + _DEBLOCK
_STEP_NAMES = [a for _, a in CONTRACT_STEPS]


def _steps(*counts):
    return dict(zip(_STEP_NAMES, counts))


CONTRACT = {
    "fused_idr": dict(
        encodes=[("I", "fused", True, 12)],
        stages=["upload", "intra"] + _DEBLOCK + ["fetch", "write"],
        spans={"enc.frame": 1, "enc.upload": 1, "enc.qp_maps": 1,
               "enc.idr": 1, "enc.to_host": 1, "enc.write": 1},
        steps=_steps(0, 1, 0, 0, 1)),
    "fused_p": dict(
        encodes=[("P", "fused", True, 0)],
        stages=["upload"] + _P_STEPS + ["fetch"] + _DEBLOCK + ["write"],
        spans={"enc.frame": 1, "enc.upload": 1, "enc.qp_maps": 1,
               "enc.pad_refs": 1, "enc.search": 1, "enc.residual": 1,
               "enc.pack": 1, "enc.to_host": 1, "enc.finish": 1,
               "enc.write": 1},
        steps=_steps(1, 0, 1, 1, 1)),
    "fused_p_intra": dict(
        encodes=[("P", "fused", True, 1)],
        stages=["upload"] + _P_STEPS + ["fetch", "intra"] + _DEBLOCK
        + ["fetch", "write"],
        spans={"enc.frame": 1, "enc.upload": 1, "enc.qp_maps": 1,
               "enc.pad_refs": 1, "enc.search": 1, "enc.residual": 1,
               "enc.pack": 1, "enc.to_host": 2, "enc.intra_fixup": 1,
               "enc.write": 1},
        steps=_steps(1, 1, 1, 1, 1)),
    "aq_idr": dict(
        encodes=[("I", "aq", True, 12)],
        stages=["upload", "aq_maps", "intra", "fetch", "write"]
        + _AQ_DEBLOCK,
        spans={"enc.frame": 1, "enc.upload": 1, "enc.qp_maps": 1,
               "enc.idr": 1, "enc.to_host": 1, "enc.write": 1,
               "enc.finish": 1},
        steps=_steps(0, 1, 0, 0, 1)),
    # the per-MB QP path fetches as the fused path does; its recon
    # (_p_finish with idc 1) and its filter after the write are each an
    # enc.finish
    "aq_p": dict(
        encodes=[("P", "aq", True, 0)],
        stages=["upload", "aq_maps"] + _P_STEPS + ["fetch", "write"]
        + _AQ_DEBLOCK,
        spans={"enc.frame": 1, "enc.upload": 1, "enc.qp_maps": 1,
               "enc.pad_refs": 1, "enc.search": 1, "enc.residual": 1,
               "enc.pack": 1, "enc.to_host": 1, "enc.write": 1,
               "enc.finish": 2},
        steps=_steps(1, 0, 1, 1, 1)),
    "aq_p_intra": dict(
        encodes=[("P", "aq", True, 1)],
        stages=["upload", "aq_maps"] + _P_STEPS + ["fetch", "intra",
                                                   "fetch", "write"]
        + _AQ_DEBLOCK,
        spans={"enc.frame": 1, "enc.upload": 1, "enc.qp_maps": 1,
               "enc.pad_refs": 1, "enc.search": 1, "enc.residual": 1,
               "enc.pack": 1, "enc.intra_fixup": 1, "enc.to_host": 2,
               "enc.write": 1, "enc.finish": 1},
        steps=_steps(1, 1, 1, 1, 1)),
    # the IDR by encode_frame, then two runs of 3; the harness's clock
    # reaches a run's steps only through the three module functions
    "run": dict(
        encodes=[("I", "fused", True, 12)] + [("P", "run", True, 0)] * 3
        + [("P", "run", True, 1)] + [("P", "run", True, 0)] * 2,
        stages=["upload", "intra"] + _DEBLOCK + ["fetch", "write"]
        + (_P_STEPS + _DEBLOCK) * 3 + _P_STEPS + ["intra"] + _DEBLOCK
        + (_P_STEPS + _DEBLOCK) * 2,
        spans={"enc.frame": 1, "enc.upload": 3, "enc.qp_maps": 3,
               "enc.idr": 1, "enc.to_host": 7, "enc.write": 1,
               "enc.run": 2, "enc.pad_refs": 6, "enc.search": 6,
               "enc.residual": 6, "enc.pack": 12, "enc.mask_fetch": 6,
               "enc.finish": 5, "enc.intra_fixup": 1, "enc.writer_wait": 2,
               "enc.writer.rows_wait": 6, "enc.writer.unpack": 6,
               "enc.writer.write": 6},
        steps=_steps(6, 2, 6, 6, 7)),
}


@pytest.mark.parametrize("path", sorted(CONTRACT_PATHS))
def test_benchmark_contract(monkeypatch, path):
    """Each frame path of the encoder (the fused IDR and P frames with and
    without intra-fallback MBs, the per-MB QP path's, and encode_frames'
    runs) marks the StageTimer names the benchmark reads, in order, opens
    the tracer's spans and calls the device steps as many times as
    pinned here, with no kernel launched on the CPU. Within
    _dispatch_p_run, _p_analyze, _p_finish and _p_intra_fixup get no
    `stage` argument (the benchmark's stage clock hands its own to such
    calls through the module attributes, as this test does) and
    _p_batch is reached through the module attribute."""
    import functools
    import importlib
    import inspect
    import threading
    from losslessh264_tpu_torch import encoder_torch as et
    from losslessh264_tpu_torch import trace

    opts, before, call = CONTRACT_PATHS[path]
    want = CONTRACT[path]
    frames = run_frames()
    enc = TorchEncoder(64, 48, qp=28, device="cpu", **opts)
    for f in frames[:before]:
        enc.encode_frame(*f)

    names = []
    main = threading.get_ident()

    class Marks:
        """The marks of the main thread, as the benchmark's stage clock
        keeps them (the writer thread's pass through untimed)."""
        def start(self):
            pass

        def __call__(self, name):
            if threading.get_ident() == main:
                names.append(name)

    enc.stages = Marks()
    steps = dict.fromkeys(_STEP_NAMES, 0)
    for mod, attr in CONTRACT_STEPS:
        owner = importlib.import_module("losslessh264_tpu_torch." + mod)

        def counted(*a, _fn=getattr(owner, attr), _attr=attr, **k):
            steps[_attr] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(owner, attr,
                            functools.wraps(getattr(owner, attr))(counted))
    # per call of _p_analyze, _p_finish or _p_intra_fixup once a run has
    # started: whether it carried a stage argument
    in_run = []
    batches = []    # the frames of each _p_batch call

    for name in ("_p_analyze", "_p_finish", "_p_intra_fixup"):
        fn = getattr(et, name)

        def clocked(*a, _fn=fn, **k):
            staged = "stage" in inspect.signature(_fn).bind(
                *a, **k).arguments
            if batches:
                in_run.append(staged)
            if not staged:
                k["stage"] = enc.stages
            return _fn(*a, **k)
        monkeypatch.setattr(et, name, clocked)
    p_batch = et._p_batch

    def batch(*a, **k):
        batches.append(len(a[4]))
        return p_batch(*a, **k)
    monkeypatch.setattr(et, "_p_batch", batch)

    with trace.recording() as rec:
        if call[0] == "frame":
            enc.encode_frame(*frames[call[1]])
        else:
            enc.encode_frames(frames[call[1]:call[2]], batch=call[3])
    assert enc.encodes == want["encodes"]
    assert names == want["stages"]
    assert rec.calls() == want["spans"]
    assert steps == want["steps"]
    assert not any(rec.launches.values())
    if call[0] == "run":
        assert batches == [3, 3]
        assert len(in_run) == 12 and not any(in_run)
    else:
        assert not batches
