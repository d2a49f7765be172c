"""harness/program_trace.py: the program's own spans read in two passes
over a window of a fixture cell's inputs on the CPU, the device's idle
gaps put down to program spans on a made-up profiler timeline, and
nothing read where the program has no tracer."""
import types

import numpy as np
import pytest

from harness import frames as gen
from harness import program_trace as pt_mod


def _decode_window(data):
    from losslessh264_tpu_torch.decoder_torch import TorchDecoder

    def run():
        for _ in range(2):
            for _ in TorchDecoder(data, device="cpu").frames():
                pass
    return run


def test_decode_passes_read_every_decode_span(tiny):
    data, _ = tiny
    pt = pt_mod.passes(_decode_window(data), "dec.frames", lambda: None)
    assert pt.frames == 16 and pt.wall_s > 0
    for names in (("dec.symbols.parse",),
                  ("dec.symbols.alloc", "dec.symbols.export"),
                  ("dec.upload",)):
        assert pt_mod.span_ms(pt, names) > 0, names
    assert pt_mod.counter_per_frame(pt, "dec.h2d_bytes", 1e-3) > 0
    # one thread: every span is the main thread's
    assert pt.main_ms == pt.self_ms
    assert pt_mod.span_ms(pt, ("dec.upload",), "other") == 0
    # no card: no profiler pass, and no idle gap to put down anywhere
    assert pt.window_s == 0 and pt_mod.idle_pct(pt, ("dec.plan",)) is None


def test_encode_passes_read_the_writer_thread():
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    plan = gen.patch_plan(np.random.default_rng(2), 64, 48, 7, 1)
    src = gen.pan_frames(64, 48, plan, seed=2)
    enc = TorchEncoder(64, 48, qp=28, gop=7, device="cpu")
    enc.encode_frames(src, batch=2)
    before = dict(enc.prof)
    pt = pt_mod.passes(lambda: enc.encode_frames(src, batch=2),
                       "enc.frames", lambda: None)
    assert pt.frames == 7
    writer = pt_mod.span_ms(pt, ("enc.writer.unpack", "enc.writer.write"),
                            "other")
    assert writer > 0
    assert pt_mod.span_ms(pt, ("enc.writer.write",), "main") is None
    # the writer's spans time calls inside prof's entropy_ms
    entropy = (enc.prof["entropy_ms"] - before["entropy_ms"]) / 7
    assert writer <= entropy
    assert pt_mod.counter_per_frame(pt, "enc.d2h_bytes", 1e-3) > 0


def test_no_tracer_reads_nothing(monkeypatch):
    monkeypatch.setattr(pt_mod, "program", lambda: None)
    pt = pt_mod.passes(lambda: None, "dec.frames", lambda: None)
    assert pt is None
    assert pt_mod.span_ms(pt, ("dec.upload",)) is None
    assert pt_mod.counter_per_frame(pt, "dec.h2d_bytes") is None
    assert pt_mod.idle_pct(pt, ("dec.plan",)) is None
    assert pt_mod.named_idle_share(pt) is None


def _ev(name, s, t, cuda=False, thread=1):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=s, end=t),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        thread=thread)


def test_idle_gaps_go_to_the_innermost_span_of_the_issuing_thread():
    p = "pip:"
    events = [
        _ev(p + "dec.frame", 0, 100), _ev(p + "dec.plan", 0, 40),
        _ev(p + "dec.plan.nnz", 10, 30), _ev(p + "dec.upload", 40, 50),
        # a thread without frame spans (the encoder's writer) overlaps
        _ev(p + "enc.writer.write", 0, 100, thread=2),
        # device work, and the ranges that show on the device timeline
        _ev("kernel", 50, 70, cuda=True), _ev("copy", 95, 100, cuda=True),
        _ev(p + "dec.frame", 0, 100, cuda=True),
        _ev("bench:plan", 0, 100, cuda=True),
        _ev("host op", 0, 130)]
    idle, busy = pt_mod.idle_by_span(events, p)
    assert busy == pytest.approx(25e-6)
    # gaps 0-50 (the plan, its nnz step, the upload), 70-95 (the frame's
    # own time), 100-130 (outside every span)
    assert idle == pytest.approx({"dec.plan": 20e-6, "dec.plan.nnz": 20e-6,
                                  "dec.upload": 10e-6, "dec.frame": 25e-6,
                                  "unlabelled": 30e-6})
    pt = pt_mod.ProgramTrace(frames=1, wall_s=1.0, self_ms={}, main_ms={},
                             counters={}, idle_s=idle, busy_s=busy,
                             window_s=130e-6)
    assert pt_mod.idle_pct(pt, ("dec.plan",)) == pytest.approx(
        100 * 40 / 130)
    assert pt_mod.named_idle_share(pt) == pytest.approx(100 * 50 / 105)


def test_gaps_cut_by_segments():
    segs = pt_mod.innermost_segments([(0, 10, "a"), (2, 4, "b"),
                                      (4, 6, "c"), (20, 30, "d")])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a"),
                    (20, 30, "d")]
    assert pt_mod.overlaps([(-5, 3), (8, 25), (40, 41)], segs) == [
        (-5, 0, "unlabelled"), (0, 2, "a"), (2, 3, "b"), (8, 10, "a"),
        (10, 20, "unlabelled"), (20, 25, "d"), (40, 41, "unlabelled")]
