"""The port's SymbolDecoder parses ahead on a native worker thread
(losslessh264_tpu_torch/native.py, csrc/sym_ahead.cpp), into planes that
its handle keeps across frames and hands on to later decoders through a
pool (csrc/sym_planes.cpp). These tests hold it to the serial
parse of the JAX package's losslessh264_tpu.native.SymbolDecoder: the
same frames, planes and keys in the same order; the same end; the native
layer's RuntimeError after the same frames; and a decoder dropped
mid-stream stops its worker and frees its handle. Exact equality
throughout; no JAX is imported."""
import ctypes
import functools
import gc
import os
import random
import re
import shutil
import sys
import threading
import time
import weakref

import numpy as np
import pytest

from losslessh264_tpu import native as jnative
from losslessh264_tpu_torch import _build
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch import trace
from losslessh264_tpu_torch.parse import split_access_units

tnative.load()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
RUNS = os.path.join(DATA, "runs720p.264")
WALK = os.path.join(ROOT, "bench_port", "data", "walk_analog_1331.264")
# every stream in tests/data: its frames
DATA_STREAMS = {"ltr_gap_64x48": 24, "runs720p": 12, "synth720p": 25,
                "walk_analog": 1000}


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def runs():
    return _read(RUNS)


@pytest.fixture(scope="module")
def runs_aus(runs):
    return [raw for raw, _ in split_access_units(runs)]


def _walk_gop0():
    """The walk stand-in's first GOP: its IDR (with the stream's
    parameter sets) and the 99 P frames after it."""
    return b"".join(raw for raw, _ in split_access_units(_read(WALK))[:100])


class _Bits:
    """An RBSP's bits, read as the syntax's u(n), ue(v) and se(v)."""

    def __init__(self, rbsp):
        self.bits = "".join(f"{b:08b}" for b in rbsp)
        self.pos = 0

    def u(self, n):
        self.pos += n
        return int(self.bits[self.pos - n:self.pos] or "0", 2)

    def ue(self):
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self):
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def _ue(v):
    b = bin(v + 1)[2:]
    return "0" * (len(b) - 1) + b


def _se(v):
    return _ue(2 * v - 1 if v > 0 else -2 * v)


def _nal(header, bits):
    """A NAL unit with a start code: `header` then the RBSP `bits` with
    its stop bit, emulation prevention applied."""
    bits += "1"
    bits += "0" * (-len(bits) % 8)
    out, zeros = bytearray(), 0
    for i in range(0, len(bits), 8):
        b = int(bits[i:i + 8], 2)
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return b"\x00\x00\x00\x01" + bytes([header]) + bytes(out)


def _with_scaling_pps(stream):
    """`stream` with each PPS rewritten to carry what the port's encoder
    never writes: chroma QP offsets of -3 and +4 and six 4x4 scaling
    lists (transform_8x8_mode 0, so the slices parse as before). The
    symbol planes differ in `scaling4`, `use_scaling` and the offsets."""
    out = []
    for m in re.finditer(rb"\x00\x00\x01(.)", stream, re.S):
        start = m.start()
        end = stream.find(b"\x00\x00\x01", m.end())
        end = len(stream) if end < 0 else end
        nal = stream[m.start(1):end].rstrip(b"\x00")
        if nal[0] & 0x1F != 8:
            out.append(stream[start:end])
            continue
        r = _Bits(nal[1:])
        bits = _ue(r.ue()) + _ue(r.ue()) + str(r.u(1)) + str(r.u(1))
        assert r.ue() == 0  # one slice group
        bits += _ue(0) + _ue(r.ue()) + _ue(r.ue()) + str(r.u(1))
        bits += f"{r.u(2):02b}" + _se(r.se()) + _se(r.se())
        r.se()
        bits += _se(-3) + str(r.u(1)) + str(r.u(1)) + str(r.u(1))
        bits += "0" + "1"  # transform_8x8_mode, pic_scaling_matrix_present
        for lst in range(6):
            bits += "1"
            last = 8
            for j in range(16):
                v = 6 + (7 * lst + 3 * j) % 40
                bits += _se((v - last + 128) % 256 - 128)
                last = v
        bits += _se(4)
        out.append(_nal(nal[0], bits))
    return b"".join(out)


@functools.lru_cache(maxsize=None)
def _scaled_cropped():
    """60x44 (4x3 MBs, cropped by 4 columns and 4 rows), five frames of
    the port's TorchEncoder on the CPU, its PPS rewritten by
    _with_scaling_pps."""
    import torch
    torch.set_num_threads(1)
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    rng = np.random.RandomState(7)
    bg = rng.randint(0, 255, (100, 120)).astype(np.uint8)
    enc = TorchEncoder(60, 44, qp=30, device="cpu")
    grey = (np.full((22, 30), 90, np.uint8), np.full((22, 30), 160, np.uint8))
    return _with_scaling_pps(b"".join(
        enc.encode_frame(np.ascontiguousarray(bg[i:i + 44, 2 * i:2 * i + 60]),
                         *grey) for i in range(5)))


def _drain(dec):
    """(the frame dicts an iterator yields, the exception that ended it,
    or None at a clean end)."""
    out = []
    try:
        for f in dec:
            out.append(f)
    except RuntimeError as e:
        return out, e
    return out, None


def _assert_same_frame(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            g = got[k]
            assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            assert type(got[k]) is type(w) and got[k] == w, (what, k)


def _step(it):
    """(the next frame or None at the end or an error, the error)."""
    try:
        return next(it), None
    except StopIteration:
        return None, None
    except RuntimeError as e:
        return None, e


def _assert_same_decode(data):
    """The port's parse-ahead and the JAX package's serial parse of
    `data`, frame by frame side by side: equal frames, and the same end
    or error after as many frames; returns (frames, error)."""
    got_it = tnative.SymbolDecoder(data)
    want_it = jnative.SymbolDecoder(data)
    n = 0
    while True:
        g, got_err = _step(got_it)
        w, want_err = _step(want_it)
        assert (g is None) == (w is None), f"frame {n}"
        if w is None:
            break
        _assert_same_frame(g, w, f"frame {n}")
        n += 1
    assert (got_err is None) == (want_err is None)
    if want_err is not None:
        assert str(got_err) == str(want_err)
    return n, got_err


def _wait_for(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.005)
    return True


@pytest.mark.parametrize("stream", sorted(DATA_STREAMS) + ["walk_gop0"])
def test_frames_equal_the_serial_parse(stream):
    if stream == "walk_gop0":
        data, want = _walk_gop0(), 100
    else:
        data = _read(os.path.join(DATA, stream + ".264"))
        want = DATA_STREAMS[stream]
    frames, err = _assert_same_decode(data)
    assert err is None
    assert frames == want


@pytest.mark.parametrize("au,frac", [(2, 0.5), (5, 0.3), (9, 0.7)])
def test_cut_mid_slice_ends_as_the_serial_parse(runs_aus, au, frac):
    """A stream cut inside a slice: the same frames, the cut one with
    its lost MBs, and the same end."""
    data = b"".join(runs_aus[:au]) + runs_aus[au][:int(
        len(runs_aus[au]) * frac)]
    frames, err = _assert_same_decode(data)
    assert err is None and frames == au + 1


# parameter sets the native layer cannot parse: pip_sym_next fails on the
# picture that is open when it reaches one
BAD_PARAMETER_SETS = [b"\x68", b"\x68\xff", b"\x67\x42",
                      b"\x67\x64\x00\x1f\x00\x00\x03\x00"]


@pytest.mark.parametrize("bad", BAD_PARAMETER_SETS)
@pytest.mark.parametrize("at", [1, 5, 11])
def test_native_error_after_the_same_frames(runs_aus, bad, at):
    data = (b"".join(runs_aus[:at]) + b"\x00\x00\x00\x01" + bad
            + b"".join(runs_aus[at:]))
    frames, err = _assert_same_decode(data)
    assert isinstance(err, RuntimeError) and frames == at - 1
    assert str(err).startswith("pip_sym_next failed")


def test_after_the_end_or_an_error_the_worker_stops(runs_aus):
    data = (b"".join(runs_aus[:3]) + b"\x00\x00\x00\x01\x68"
            + b"".join(runs_aus[3:]))
    live = tnative._build.host_lib().pip_ahead_live
    before = live()
    dec = tnative.SymbolDecoder(data)
    frames, err = _drain(dec)
    assert err is not None and len(frames) == 2
    with pytest.raises(StopIteration):
        next(dec)
    ended = tnative.SymbolDecoder(b"".join(runs_aus[:2]))
    assert len(list(ended)) == 2
    with pytest.raises(StopIteration):
        next(ended)
    # both workers have left, though their decoders are still held
    assert _wait_for(lambda: live() == before)
    del dec, ended


def _native_functions(monkeypatch, next_=None, planes=None, close=None):
    """Hand the worker stand-ins for pip_pooled_next, pip_pooled_planes
    or pip_pooled_close: each is called as `fn(real, *args)` from the
    worker's thread, `real` the host library's function. Returns the
    callbacks, which the caller keeps alive while a worker may call
    them."""
    real = tnative._sym_functions(_build.host_lib())
    P, I = ctypes.c_void_p, ctypes.c_int
    protos = [ctypes.CFUNCTYPE(I, P, P, P, P, ctypes.c_size_t),
              ctypes.CFUNCTYPE(I, *[P] * 32),
              ctypes.CFUNCTYPE(None, P)]
    keep, addrs = [], []
    for proto, addr, fn in zip(protos, real, (next_, planes, close)):
        if fn is None:
            addrs.append(addr)
            continue
        cb = proto(functools.partial(fn, proto(addr)))
        keep.append(cb)
        addrs.append(ctypes.cast(cb, ctypes.c_void_p).value)
    monkeypatch.setattr(tnative, "_sym_functions", lambda lib: addrs)
    return keep


def test_planes_failure_comes_in_stream_order(monkeypatch, runs):
    """pip_sym_planes failing on the third frame: the consumer gets the
    two frames before it, then the failure, then the end."""
    calls = []

    def third_fails(real, *args):
        calls.append(1)
        return -1 if len(calls) == 3 else real(*args)
    keep = _native_functions(monkeypatch, planes=third_fails)
    dec = tnative.SymbolDecoder(runs)
    want = list(jnative.SymbolDecoder(runs))[:2]
    for i, w in enumerate(want):
        _assert_same_frame(next(dec), w, f"frame {i}")
    with pytest.raises(RuntimeError, match="pip_sym_planes failed"):
        next(dec)
    with pytest.raises(StopIteration):
        next(dec)
    assert len(calls) == 3
    del dec, keep


def test_depth_one_gives_the_same_bytes(monkeypatch):
    """The queue's depth changes when a frame is parsed, not what it
    holds: depth 1 against the class's own depth, byte for byte."""
    data = _walk_gop0()
    ours = list(tnative.SymbolDecoder(data))
    monkeypatch.setattr(tnative.SymbolDecoder, "_DEPTH", 1)
    ones = list(tnative.SymbolDecoder(data))
    assert tnative.SymbolDecoder._DEPTH == 1 and len(ours) == len(ones) == 100
    for i, (a, b) in enumerate(zip(ours, ones)):
        assert list(a) == list(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (i, k)
            else:
                assert a[k] == b[k], (i, k)


def _host():
    return tnative._build.host_lib()


def test_worker_stays_within_its_depth(runs):
    """While the consumer holds still, the worker parses `_DEPTH` frames
    ahead and no further."""
    dec = tnative.SymbolDecoder(runs)
    next(dec)
    depth = tnative.SymbolDecoder._DEPTH
    assert 2 <= depth <= 4

    def queued():
        return _host().pip_ahead_queued(dec._ahead)
    assert _wait_for(lambda: queued() == depth)
    time.sleep(0.1)
    assert queued() == depth
    assert len(list(dec)) == 11


def test_never_iterated_starts_no_thread_and_frees_its_handle(monkeypatch,
                                                               runs):
    lib = _build.host_lib()
    closed = []
    close = lib.pip_pooled_close
    monkeypatch.setattr(lib, "pip_pooled_close",
                        lambda h: (closed.append(h), close(h)))
    live = _host().pip_ahead_live()
    before = threading.active_count()
    dec = tnative.SymbolDecoder(runs)
    assert dec._ahead is None and _host().pip_ahead_live() == live
    assert threading.active_count() == before
    h = dec._h
    del dec
    assert closed == [h]


def test_dropped_decoders_stop_their_workers(monkeypatch, runs):
    """200 decoders, each dropped after 0, 1 or 2 frames: every worker
    ends and closes its handle once, nothing else is left running, and
    no reference to the decoder outlives it."""
    closed = []

    def counted(real, h):
        closed.append(h)
        real(h)
    keep = _native_functions(monkeypatch, close=counted)
    lib = _build.host_lib()
    opened = []
    open_ = lib.pip_pooled_open

    def counted_open(*a):
        h = open_(*a)
        opened.append(h)
        return h
    monkeypatch.setattr(lib, "pip_pooled_open", counted_open)
    closes = lib.pip_pooled_close
    monkeypatch.setattr(lib, "pip_pooled_close",
                        lambda h: (closed.append(h), closes(h)))
    gc.collect()
    before = threading.active_count()
    live = _host().pip_ahead_live()
    for i in range(200):
        dec = tnative.SymbolDecoder(runs)
        for _ in range(i % 3):
            next(dec)
        if i == 1:
            assert _host().pip_ahead_live() == live + 1
            ref = weakref.ref(dec)
        del dec
        if i == 1:
            # refcounting alone frees it
            assert ref() is None
    assert _wait_for(lambda: _host().pip_ahead_live() == live)
    assert threading.active_count() == before
    assert _wait_for(lambda: len(closed) == 200)
    # (a freed handle's address may come back for a later decoder)
    assert len(opened) == 200 and sorted(closed) == sorted(opened)
    del keep


def test_frames_outlive_their_decoder_and_free_their_buffer(runs):
    """A frame's planes are views of one buffer of the worker's, which
    stays while any of them does and is freed with the last."""
    frames = list(tnative.SymbolDecoder(runs))
    want = list(jnative.SymbolDecoder(runs))
    gc.collect()
    luma = [f["luma_ac"] for f in frames]
    block = luma[0].base.base
    freed = weakref.ref(block)
    del frames, block
    gc.collect()
    assert freed() is not None
    for i, (g, w) in enumerate(zip(luma, want)):
        np.testing.assert_array_equal(g, w["luma_ac"], err_msg=f"{i}")
    del luma, g
    assert freed() is None


def test_ahead_counter_and_wait_span(monkeypatch, runs):
    """A consumer slower than the parse finds every frame but the first
    ready (`dec.symbols_ahead`); a parse slower than the consumer makes
    each `__next__` wait (`dec.symbols.wait`) and none ahead. The
    worker's steps are its own spans, timed on its thread."""
    with trace.recording() as rec:
        dec = tnative.SymbolDecoder(runs)
        n = 0
        for _ in dec:
            n += 1
            time.sleep(0.05)
    assert n == 12
    assert rec.counters["dec.symbols_ahead"] >= n - 1
    assert rec.calls().get("dec.symbols.wait", 0) <= 1
    worker = {s.thread for s in rec.spans
              if s.name.startswith("dec.symbols.") and s.name != "dec.symbols.wait"}
    assert len(worker) == 1 and rec.thread not in worker
    calls = rec.calls()
    assert calls["dec.symbols.parse"] == n + 1
    assert calls["dec.symbols.alloc"] == calls["dec.symbols.export"] == n

    def slow(real, *args):
        time.sleep(0.02)
        return real(*args)
    keep = _native_functions(monkeypatch, next_=slow)
    with trace.recording() as rec:
        assert len(list(tnative.SymbolDecoder(runs))) == n
    assert "dec.symbols_ahead" not in rec.counters
    calls = rec.calls(thread=rec.thread)
    assert calls["dec.symbols.wait"] == n + 1
    assert rec.total_ms(thread=rec.thread)["dec.symbols.wait"] >= 0.02e3 * n
    # the parse spans hold the worker's sleeps
    assert rec.total_ms()["dec.symbols.parse"] >= 0.02e3 * (n + 1)
    del keep


def test_decoders_on_many_threads_at_once(runs):
    """More consumer threads than cores, each iterating decoders of two
    streams and dropping some mid-stream, with a short switch interval:
    every frame equals the serial parse's at its place, and every worker
    ends."""
    walk = _walk_gop0()[:400000]
    streams = {"runs": runs, "walk": walk}
    want = {k: list(jnative.SymbolDecoder(d)) for k, d in streams.items()}
    live = tnative._build.host_lib().pip_ahead_live
    before = live()
    bad = []

    def consume(seed):
        rng = random.Random(seed)
        for _ in range(12):
            k = rng.choice(sorted(streams))
            stop = rng.choice([0, 1, 3, None])
            for i, f in enumerate(tnative.SymbolDecoder(streams[k])):
                w = want[k][i]
                if not (np.array_equal(f["luma_ac"], w["luma_ac"])
                        and np.array_equal(f["mv"], w["mv"])
                        and f["ref_list"] == w["ref_list"]):
                    bad.append((k, i))
                if stop is not None and i + 1 >= stop:
                    break
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(s,))
                   for s in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    gc.collect()
    assert _wait_for(lambda: live() == before)


def _pool():
    """(FramePlanes in the pool, their bytes)."""
    out = np.zeros(2, np.int64)
    _build.host_lib().pip_pooled_kept(out.ctypes.data)
    return tuple(out.tolist())


def test_scaled_stream_sets_what_the_others_leave():
    """The rewritten stream's frames carry the fields that no other
    stream of these tests sets, so planes it leaves behind would show."""
    f = next(jnative.SymbolDecoder(_scaled_cropped()))
    assert (f["mb_w"], f["mb_h"], f["crop_px"]) == (4, 3, (0, 4, 0, 4))
    assert f["use_scaling"] and f["scaling4"].min() >= 6
    assert (f["chroma_qp_offset"], f["second_chroma_qp_offset"]) == (-3, 4)
    g = next(jnative.SymbolDecoder(_read(os.path.join(
        DATA, "ltr_gap_64x48.264"))))
    assert (g["mb_w"], g["mb_h"], g["crop_px"]) == (4, 3, (0, 0, 0, 0))
    assert not g["use_scaling"] and not g["scaling4"].any()


def test_pooled_planes_across_sizes_decoders_and_threads(runs):
    """Decoders of 64x48 (4x3 MBs: the scaled, cropped stream and the
    long-term-reference stream take each other's planes), 640x352 and
    720p, and streams that change size midway, in alternation on one
    thread and then on several at once: every frame equals the serial
    parse's, the planes pass from decoder to decoder, and the pool stays
    within its bound."""
    scaled = _scaled_cropped()
    ltr = _read(os.path.join(DATA, "ltr_gap_64x48.264"))
    walk = b"".join(raw for raw, _ in split_access_units(_read(WALK))[:12])
    runs4 = b"".join(raw for raw, _ in split_access_units(runs)[:4])
    streams = {"scaled": scaled, "ltr": ltr, "walk": walk, "runs": runs,
               "grows": scaled + runs4, "shrinks": runs4 + scaled + ltr}
    want = {k: list(jnative.SymbolDecoder(d)) for k, d in streams.items()}
    assert [len(want[k]) for k in ("grows", "shrinks")] == [9, 33]

    def decode(k, check):
        n = 0
        for i, f in enumerate(tnative.SymbolDecoder(streams[k])):
            check(f, want[k][i], f"{k} frame {i}")
            n += 1
        assert n == len(want[k]), k
    order = ["scaled", "ltr", "runs", "scaled", "walk", "ltr", "grows",
             "scaled", "shrinks", "ltr", "runs", "walk", "scaled", "ltr"]
    for k in order:
        decode(k, _assert_same_frame)
    # a second round: each decoder's planes come from one before it, but
    # for the first 720p frame after "grows"' 4x3-MB frames, which makes
    # them grow, and the next "scaled" one, whose 4x3-MB planes "grows"
    # took unless the tests before left another
    with trace.recording() as rec:
        for k in order:
            decode(k, _assert_same_frame)
    frames = sum(len(want[k]) for k in order)
    assert frames - 2 <= rec.counters["dec.symbols_planes_kept"] < frames

    bad = []

    def check(f, w, what):
        try:
            _assert_same_frame(f, w, what)
        except AssertionError:
            bad.append(what)

    def consume(seed):
        rng = random.Random(seed)
        for _ in range(10):
            decode(rng.choice(sorted(streams)), check)
    threads = [threading.Thread(target=consume, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    kept, nbytes = _pool()
    assert 1 <= kept and nbytes <= 256 << 20


def test_planes_kept_over_fresh_decoders(runs_aus):
    """20 passes of 5-12 frames of runs720p, a fresh decoder each: the
    planes of every frame but at most the first decoder's first were
    taken from the pool or kept from the frame before."""
    rng = random.Random(22)
    frames = 0
    with trace.recording() as rec:
        for _ in range(20):
            data = b"".join(runs_aus[:rng.randint(5, 12)])
            frames += sum(1 for _ in tnative.SymbolDecoder(data))
    assert frames >= 100
    assert rec.counters["dec.symbols_planes_kept"] >= 0.99 * frames
    assert rec.counters["dec.symbols_faults"] >= 0


def _included(paths, dirs):
    """The quoted #includes of `paths`, followed through `dirs`."""
    seen, todo = set(), list(paths)
    while todo:
        with open(todo.pop()) as fh:
            for name in re.findall(r'^#include "([^"]+)"', fh.read(), re.M):
                for d in dirs:
                    p = os.path.join(d, name)
                    if os.path.exists(p) and p not in seen:
                        seen.add(p)
                        todo.append(p)
                        break
    return seen


def test_host_library_rebuilds_for_the_native_headers_it_includes(tmp_path):
    """In a copy of the host library's inputs: a library newer than all
    of them is current, and one older than any native/src header that
    its sources include is stale (FramePlanes' layout is compiled into
    both libraries)."""
    native_src = os.path.join(ROOT, "native", "src")
    csrc = os.path.join(ROOT, "losslessh264_tpu_torch", "csrc")
    headers = {p for p in _included(_build.host_sources(), [csrc, native_src])
               if p.startswith(native_src + os.sep)}
    assert os.path.join(native_src, "decsupport.h") in headers
    inputs = _build.host_inputs(ROOT)
    assert headers <= set(inputs)
    t0 = time.time() - 1000
    for p in inputs:
        dst = tmp_path / os.path.relpath(p, ROOT)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(p, dst)
        os.utime(dst, (t0, t0))
    lib = tmp_path / "build" / "host" / "libpip_plan.so"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    os.utime(lib, (t0 + 10, t0 + 10))
    assert not _build.needs_host_build(str(tmp_path))
    for h in sorted(headers):
        copy = tmp_path / os.path.relpath(h, ROOT)
        os.utime(copy, (t0 + 20, t0 + 20))
        assert _build.needs_host_build(str(tmp_path)), h
        os.utime(copy, (t0, t0))
    assert not _build.needs_host_build(str(tmp_path))
