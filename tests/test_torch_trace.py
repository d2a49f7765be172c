"""The port's tracer (losslessh264_tpu_torch/trace.py): off it records
nothing and touches no clock, synchronize or profiler range; a recording
keeps every thread's spans with their nesting and self times; the
decoder and the encoder emit their spans and counters where the work
happens; the span and counter names are pinned, so that a rename fails
here instead of silently emptying a reading that looks them up."""
import contextlib
import os
import re
import threading
import time
import types

import numpy as np
import pytest
import torch

from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch import trace
from losslessh264_tpu_torch.encoder_torch import TorchEncoder
from test_torch_decoder import tiny_frames, tiny_stream_bytes

tnative.load()
torch.set_num_threads(1)

PKG = os.path.dirname(os.path.abspath(trace.__file__))

# every span the port opens, and every counter it adds to
SPANS = {
    "dec.open", "dec.frame", "dec.symbols", "dec.symbols.wait",
    "dec.symbols.parse", "dec.symbols.alloc", "dec.symbols.export",
    "dec.plan", "dec.plan.refs",
    "dec.plan.slots", "dec.plan.intra", "dec.plan.avail", "dec.plan.nnz",
    "dec.plan.mc", "dec.plan.scaling", "dec.plan.deblock", "dec.upload",
    "dec.inter", "dec.inter.cells", "dec.residual", "dec.intra",
    "dec.deblock", "dec.deblock.params", "dec.deblock.filter",
    "dec.deblock.crop",
    "dec.store", "dec.conceal",
    "enc.frame", "enc.run", "enc.upload", "enc.qp_maps", "enc.pad_refs",
    "enc.search", "enc.residual", "enc.pack", "enc.mask_fetch",
    "enc.intra_fixup",
    "enc.finish", "enc.to_host", "enc.idr", "enc.write", "enc.writer_wait",
    "enc.writer.rows_wait", "enc.writer.unpack", "enc.writer.write",
}
COUNTERS = {"dec.frames", "dec.h2d_bytes", "dec.h2d_copies",
            "dec.symbol_bytes", "dec.symbols_ahead",
            "dec.symbols_planes_kept", "dec.symbols_faults",
            "dec.mc_bucketed", "dec.mc_slots",
            "dec.mc_spilled", "dec.mc_cells",
            "dec.mc_cells_n", "dec.mc_cells_wp",
            "enc.frames", "enc.h2d_bytes", "enc.d2h_bytes"}
# the main thread's leaf spans of every frame of an undamaged decode
# outside a batch
DECODE_LEAVES = {"dec.plan.refs", "dec.plan.slots",
                 "dec.plan.intra", "dec.plan.avail", "dec.plan.nnz",
                 "dec.plan.mc", "dec.plan.scaling", "dec.upload",
                 "dec.inter", "dec.residual", "dec.intra", "dec.store"}
# the parse-ahead worker's spans (native.SymbolDecoder, trace.add_span):
# one native thread per iterated decoder, no frame id
DECODE_WORKER = {"dec.symbols.parse", "dec.symbols.alloc",
                 "dec.symbols.export"}


def _names_in_sources(call):
    """The string literals passed as first argument to trace.<call>(...)
    anywhere in the package."""
    out = set()
    pat = re.compile(r"trace\." + call + r"\(\s*\"([^\"]+)\"")
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    out |= set(pat.findall(fh.read()))
    return out


def test_span_and_counter_names_are_pinned():
    assert _names_in_sources("span") | _names_in_sources(
        "add_span") == SPANS
    assert _names_in_sources("count") | _names_in_sources(
        "count_bytes") == COUNTERS


@pytest.fixture(scope="module")
def tiny():
    return tiny_stream_bytes()


def test_off_touches_no_clock_synchronize_or_profiler(monkeypatch, tiny):
    """No recording: the decode and a batched encode run with the
    tracer's clock, torch's synchronize, its profiler check and
    record_function all made to raise."""
    def boom(*a, **k):
        raise AssertionError("the tracer did work while off")
    monkeypatch.setattr(trace, "time",
                        types.SimpleNamespace(perf_counter_ns=boom))
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert trace.span("a") is trace.span("b")
    assert trace.new_frame() is None and not trace.on()
    assert len(list(dt.TorchDecoder(tiny, device="cpu").frames())) == 6
    enc = TorchEncoder(64, 48, qp=28, device="cpu")
    assert len(enc.encode_frames(tiny_frames(), batch=2)) == 6


def _spans_under_profiler(recording):
    """The names of the tracer's ranges in a profiler window around a
    few spans, with or without a recording."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() if recording else contextlib.nullcontext():
            with trace.span("dec.frame"):
                with trace.span("dec.upload"):
                    torch.zeros(4).add_(1)
            with trace.span("enc.frame"):
                pass
    return sorted(e.name for e in prof.events()
                  if e.name.startswith(trace.PREFIX))


def test_off_opens_no_profiler_range():
    assert _spans_under_profiler(None) == []


def test_self_time_nesting_threads_and_counters():
    def worker():
        with trace.span("t.worker", frame=7):
            time.sleep(0.01)
        trace.count("t.n", 2)

    with trace.recording() as rec:
        with trace.span("t.outer", frame=trace.new_frame()) as outer:
            time.sleep(0.02)
            with trace.span("t.inner"):
                time.sleep(0.03)
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
        trace.count("t.n")
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    assert not th.is_alive()
    assert rec.counters == {"t.n": 3}
    spans = {s.name: s for s in rec.spans}
    inner, out_, work = (spans[n] for n in ("t.inner", "t.outer",
                                            "t.worker"))
    assert inner.parent == outer.id == out_.id and out_.parent is None
    assert inner.frame == out_.frame == 0 and work.frame == 7
    assert work.parent is None and work.thread != out_.thread
    assert out_.thread == rec.thread
    self_ms, total = rec.self_ms(), rec.total_ms()
    assert self_ms["t.outer"] == pytest.approx(
        total["t.outer"] - total["t.inner"])
    assert 15 <= self_ms["t.outer"] and 25 <= self_ms["t.inner"]
    assert self_ms["t.worker"] >= 8
    assert rec.self_ms(thread=work.thread) == {
        "t.worker": self_ms["t.worker"]}
    assert rec.calls() == {"t.outer": 1, "t.inner": 1, "t.worker": 1}
    assert set(rec.by_frame()) == {0, 7}
    assert not trace.on()


def test_sync_mode_synchronizes_at_each_edge(monkeypatch):
    calls = []
    monkeypatch.setattr(trace.Recording, "_synchronize",
                        lambda self: calls.append(1))
    with trace.recording(sync=True):
        with trace.span("a"), trace.span("b"):
            pass
    # the recording's start and stop, and each span's two edges
    assert len(calls) == 2 + 4


def test_worker_spans_never_synchronize(monkeypatch, tiny):
    """Under recording(sync=True) the main thread's spans synchronize at
    their edges and the parse-ahead worker's spans not at all: a
    synchronize there would time the main thread's kernels as parse."""
    who = []
    monkeypatch.setattr(trace.Recording, "_synchronize",
                        lambda self: who.append(threading.get_ident()))
    with trace.recording(sync=True) as rec:
        n = len(list(dt.TorchDecoder(tiny, device="cpu").frames()))
    worker = {s.thread for s in rec.spans if s.name in DECODE_WORKER}
    assert n == 6 and len(worker) == 1 and rec.thread not in worker
    assert set(who) == {rec.thread}
    main = [s for s in rec.spans if s.thread == rec.thread]
    assert len(who) == 2 + 2 * len(main)


def test_spans_open_profiler_ranges_while_recording():
    assert _spans_under_profiler(trace.recording) == [
        trace.PREFIX + n for n in ("dec.frame", "dec.upload", "enc.frame")]


def test_launches_are_deltas_of_the_wrappers():
    from losslessh264_tpu_torch.ops import mc as tmc
    with trace.recording() as rec:
        tmc.halfpel_planes.launches += 2
    assert rec.launches["K1"] == 2
    assert set(rec.launches) == {k for k, _, _ in trace.LAUNCH_COUNTERS}


def test_decode_spans_and_counters(monkeypatch, tiny):
    """Each main-thread leaf span once per frame, the frames' spans
    sharing their frame id; the parse-ahead worker's spans once per
    parse, on a thread of their own; each read of a frame either found
    it queued (dec.symbols_ahead) or waited (dec.symbols.wait); the
    upload counters equal to the plane dicts' bytes."""
    uploaded = []
    to_torch = dt.planes_to_torch

    def keep(planes, device):
        out = to_torch(planes, device)
        uploaded.append(out)
        return out
    monkeypatch.setattr(dt, "planes_to_torch", keep)
    with trace.recording() as rec:
        n = len(list(dt.TorchDecoder(tiny, device="cpu").frames()))
    calls = rec.calls()
    assert n == 6 and rec.counters["dec.frames"] == n
    for name in (DECODE_LEAVES | DECODE_WORKER
                 | {"dec.frame", "dec.plan", "dec.deblock"}):
        # the parse is tried once more, to find the stream's end
        assert calls[name] == n + (name == "dec.symbols.parse"), name
    assert calls["dec.open"] == 1 and "dec.conceal" not in calls
    threads = {}
    for s in rec.spans:
        threads.setdefault(s.thread, set()).add(s.name)
    others = [t for t in threads if t != rec.thread]
    assert len(others) == 1 and threads[others[0]] == DECODE_WORKER
    assert not DECODE_WORKER & threads[rec.thread]
    names = {s.id: s.name for s in rec.spans}
    waits = [s for s in rec.spans if s.name == "dec.symbols.wait"]
    assert {names[s.parent] for s in waits} <= {"dec.symbols"}
    assert all(s.frame is None for s in rec.spans
               if s.name in DECODE_WORKER)
    # n + 1 reads: each frame's, and the one that found the end
    ahead = rec.counters.get("dec.symbols_ahead", 0)
    assert ahead <= n and ahead + len(waits) in (n, n + 1)
    tensors = [t for p in uploaded for v in p.values()
               if isinstance(v, (list, torch.Tensor))
               for t in (v if isinstance(v, list) else [v])]
    assert rec.counters["dec.h2d_copies"] == len(tensors)
    assert rec.counters["dec.h2d_bytes"] == sum(
        t.numel() * t.element_size() for t in tensors)
    syms = list(tnative.SymbolDecoder(tiny))
    assert rec.counters["dec.symbol_bytes"] == sum(
        a.nbytes for f in syms for a in f.values()
        if isinstance(a, np.ndarray)) + n * 4 * (12 + 19 + 18)
    # a frame id per frame, and one for the read that found the end
    frames = list(rec.by_frame().values())
    assert len(frames) == n + 1 and "dec.symbols" in frames[-1] and set(
        frames[-1]) <= {"dec.symbols", "dec.symbols.wait"}
    for row in frames[:-1]:
        assert DECODE_LEAVES | {"dec.symbols"} <= set(row)
    # the main thread's spans do not overlap: their self times add up to
    # at most the recording's wall time
    assert sum(rec.self_ms(thread=rec.thread).values()) <= rec.wall_ms


def test_plan_counters_on_runs720p(monkeypatch):
    """A recorded decode of runs720p (its 4 IDRs as a batch, 8 P frames)
    plans each frame once (dec.plan.mc) and counts dec.mc_spilled once
    per frame on which the numpy plan spills (more than MC_CAP distinct
    fast triples), judged on the same planes."""
    from losslessh264_tpu_torch.ops import mc as tmc
    from test_torch_plan_host import numpy_spills
    seen = []
    plan = tmc.mc_plan

    def keep(mb_w, mb_h, ref_slot, mv, pad):
        seen.append((mb_w, mb_h, ref_slot.copy(), mv.copy(), pad))
        return plan(mb_w, mb_h, ref_slot, mv, pad)
    monkeypatch.setattr(tmc, "mc_plan", keep)
    path = os.path.join(os.path.dirname(__file__), "data", "runs720p.264")
    with open(path, "rb") as fh:
        data = fh.read()
    with trace.recording() as rec:
        n = len(list(dt.TorchDecoder(data, device="cpu").frames()))
    calls = rec.calls()
    assert n == len(seen) == 12
    assert calls["dec.plan.mc"] == n
    spills = sum(numpy_spills(*a) for a in seen)
    assert rec.counters["dec.mc_spilled"] == spills == 8


def test_cells_route_counters_on_walk(monkeypatch):
    """A recorded decode of walk_analog's first 6 frames (an IDR, then P
    frames the plan spills) counts dec.mc_cells and opens dec.inter.cells
    once per frame on the per-cell route (a plan with inter cells and
    mc_fast False), dec.mc_cells_n their inter cells, and no WP frame;
    the route's span sits inside dec.inter."""
    from losslessh264_tpu_torch.ops import mc as tmc
    from losslessh264_tpu_torch.parse import split_access_units
    seen = []
    plan = tmc.mc_plan

    def keep(mb_w, mb_h, ref_slot, mv, pad):
        out = plan(mb_w, mb_h, ref_slot, mv, pad)
        seen.append((int((ref_slot >= 0).sum()), bool(out[0]["mc_fast"])))
        return out
    monkeypatch.setattr(tmc, "mc_plan", keep)
    path = os.path.join(os.path.dirname(__file__), "data", "walk_analog.264")
    with open(path, "rb") as fh:
        data = fh.read()
    clip = b"".join(raw for raw, _ in split_access_units(data)[:6])
    with trace.recording() as rec:
        n = len(list(dt.TorchDecoder(clip, device="cpu").frames()))
    routed = [k for k, fast in seen if k and not fast]
    assert n == len(seen) == 6 and len(routed) == 5
    assert rec.counters["dec.mc_cells"] == rec.calls()["dec.inter.cells"] \
        == len(routed)
    assert rec.counters["dec.mc_cells_n"] == sum(routed)
    assert "dec.mc_cells_wp" not in rec.counters
    names = {s.id: s.name for s in rec.spans}
    assert {names[s.parent] for s in rec.spans
            if s.name == "dec.inter.cells"} == {"dec.inter"}


def test_cells_route_counts_wp_frames():
    """The per-cell route counts a frame with explicit weighted prediction
    in dec.mc_cells_wp, beside dec.mc_cells."""
    from losslessh264_tpu_torch.cases import random_cells_case
    *rings, pad, p = random_cells_case(9, 4, 2, wp=True)
    with trace.recording() as rec:
        dt._inter_pred(9, 4, p, *rings)
    assert rec.counters == {"dec.mc_cells": 1, "dec.mc_cells_wp": 1}


def test_intra_batch_is_one_frame_span():
    enc = TorchEncoder(64, 48, qp=28, intra_only=True, device="cpu")
    data = b"".join(enc.encode_frame(*f) for f in tiny_frames()[:4])
    with trace.recording() as rec:
        dec = dt.TorchDecoder(data, device="cpu")
        n = len(list(dec.frames()))
    calls = rec.calls()
    assert n == 4 and dec.routes == [("batch", 4)] * 4
    assert calls["dec.frame"] == 1 and calls["dec.intra"] == 1
    assert calls["dec.upload"] == calls["dec.plan.deblock"] == 4
    assert rec.counters["dec.frames"] == 4


def test_encode_runs_record_the_writer_thread():
    enc = TorchEncoder(64, 48, qp=28, gop=6, device="cpu")
    frames = tiny_frames()
    enc.encode_frames(frames, batch=2)   # the IDR, warm
    before = dict(enc.prof)
    with trace.recording() as rec:
        out = enc.encode_frames(frames[:5], batch=2)
    assert len(out) == 5 and rec.counters["enc.frames"] == 5
    threads = {}
    for s in rec.spans:
        threads.setdefault(s.thread, set()).add(s.name)
    writer = {"enc.writer.rows_wait", "enc.writer.unpack",
              "enc.writer.write"}
    others = [t for t in threads if t != rec.thread]
    assert len(others) == 1 and threads[others[0]] == writer
    assert not writer & threads[rec.thread]
    calls = rec.calls()
    assert calls["enc.run"] == 2 and calls["enc.writer.write"] == 4
    assert calls["enc.writer_wait"] == 2 and calls["enc.frame"] == 1
    assert calls["enc.mask_fetch"] == 4 and calls["enc.search"] == 4
    # the writer's spans time the calls that prof's entropy_ms times
    total = rec.total_ms(thread=others[0])
    entropy = enc.prof["entropy_ms"] - before["entropy_ms"]
    assert 0 < total["enc.writer.unpack"] + total["enc.writer.write"] \
        <= entropy
    # the writer's spans of a run share the run's frame id
    run_ids = {s.frame for s in rec.spans if s.name == "enc.run"}
    assert {s.frame for s in rec.spans
            if s.name.startswith("enc.writer.")} == run_ids
    n = 64 * 48
    assert rec.counters["enc.h2d_bytes"] == 5 * n * 3 // 2
    assert rec.counters["enc.d2h_bytes"] > 0


def test_stage_timer_is_the_marker_mode():
    assert et.StageTimer is trace.StageTimer
    timer = trace.StageTimer("cpu")
    timer.start()
    time.sleep(0.005)
    timer("a")
    timer("b")
    assert set(timer.ms) == {"a", "b"} and timer.ms["a"] >= 4
