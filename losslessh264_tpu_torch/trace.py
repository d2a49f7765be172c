"""The port's tracer: named spans and counters at the layer boundaries of
the decode and encode paths, and the encoder's stage marks.

    from losslessh264_tpu_torch import trace
    with trace.recording() as rec:
        for _ in TorchDecoder(data).frames():
            pass
    rec.self_ms()    # {span name: ms less the time its child spans cover}
    rec.counters     # {"dec.frames": ..., "dec.h2d_bytes": ...}
    rec.launches     # {"K1": ..., "K9": ...}: kernel launches meanwhile

Off, the default, `span(name)` returns one shared object whose `with`
does nothing and `count` returns after one test of a module global:
nothing synchronizes, allocates, reads a clock or opens a profiler range.

While a recording is installed (one at a time, for the whole process)
every thread's spans are kept in memory: name, parent, thread, frame id
(the spans of one frame share it; a child takes its parent's; a run of P
frames or a batch of intra frames is one), and perf_counter_ns start and
end. `recording(sync=True)` starts and ends each span with a device
synchronize, so that a span holds its own device work (the StageTimer's
rule). While a torch profiler is active too, each span also opens a
`record_function` range named PREFIX + name, on the profiler's host
timeline beside the device's kernels. Kernel launches come from the
wrappers' `launches` attributes (_build.count_launch), read at the
recording's start and stop.
"""
from __future__ import annotations

import contextlib
import importlib
import itertools
import threading
import time
from dataclasses import dataclass

PREFIX = "pip:"   # the program's record_function ranges

# K1-K9 and K11: the kernel wrappers whose `launches` _build.count_launch
# advances
LAUNCH_COUNTERS = (
    ("K1", "ops.mc", "halfpel_planes"),
    ("K2", "ops.deblock", "deblock_wavefront"),
    ("K3", "ops.intra", "intra_recon"),
    ("K4", "encoder_torch", "intra_wavefront"),
    ("K5", "ops.me", "dense_full_search"),
    ("K6", "ops.mc", "mc_bucketed"),
    ("K7", "decoder_torch", "_residual_recon"),
    ("K8", "encoder_torch", "inter_residual"),
    ("K9", "ops.deblock", "edge_params_packed"),
    ("K11", "ops.mc", "mc_cells"),
)

_rec = None   # the installed Recording


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name, frame=None):
    """A `with` block traced as `name`; `frame` starts a frame id (else
    the enclosing span's)."""
    rec = _rec
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, frame)


def add_span(name, t0, t1, thread):
    """Record a span that a thread outside the interpreter timed (`t0`,
    `t1` on perf_counter_ns's clock, CLOCK_MONOTONIC) as that thread's:
    no parent, no frame id, no synchronize, no profiler range."""
    rec = _rec
    if rec is None:
        return
    rec.spans.append(Span(next(rec._ids), name, None, thread, None, t0, t1))


def count(name, n=1):
    """Add n to the counter `name` of the installed recording."""
    rec = _rec
    if rec is None:
        return
    with rec._lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def count_bytes(name, *arrays):
    """Add the bytes of numpy arrays or tensors to the counter `name`."""
    if _rec is None:
        return
    count(name, sum(a.nbytes for a in arrays))


def new_frame():
    """A frame id unique within the installed recording (None when off)."""
    rec = _rec
    return None if rec is None else next(rec._frames)


def on():
    return _rec is not None


@dataclass(frozen=True)
class Span:
    """One recorded span: perf_counter_ns `t0`, `t1`; `parent` the id of
    the enclosing span on the same thread (None at the top)."""
    id: int
    name: str
    parent: int | None
    thread: int
    frame: int | None
    t0: int
    t1: int


class _Span:
    __slots__ = ("rec", "name", "frame", "id", "parent", "t0", "range")

    def __init__(self, rec, name, frame):
        self.rec, self.name, self.frame = rec, name, frame

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        if self.frame is None and top is not None:
            self.frame = top.frame
        self.id = next(rec._ids)
        stack.append(self)
        if rec.sync:
            rec._synchronize()
        self.range = None
        if rec._torch.autograd._profiler_enabled():
            self.range = rec._torch.profiler.record_function(
                PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec.sync:
            rec._synchronize()
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec._stack().pop()
        rec.spans.append(Span(self.id, self.name, self.parent,
                              threading.get_ident(), self.frame, self.t0, t1))
        return False


class Recording:
    """What one `recording()` kept: `spans` (Span, in the order they
    ended), `counters`, `launches` (K1-K9 and K11 launches between start
    and stop), `t0`/`t1` (perf_counter_ns) and `thread` (the thread that
    installed it)."""

    def __init__(self, sync=False):
        import torch
        self._torch = torch
        self.sync = bool(sync)
        self.spans = []
        self.counters = {}
        self.launches = {}
        self.thread = threading.get_ident()
        self.t0 = self.t1 = None
        self._ids = itertools.count()
        self._frames = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _synchronize(self):
        if self._torch.cuda.is_initialized():
            self._torch.cuda.synchronize()

    @property
    def wall_ms(self):
        return (self.t1 - self.t0) / 1e6

    def _child_ns(self):
        child = {}
        for s in self.spans:
            if s.parent is not None:
                child[s.parent] = child.get(s.parent, 0) + s.t1 - s.t0
        return child

    def self_ms(self, thread=None):
        """{name: summed self time in ms}: each span's duration less the
        time its child spans cover; `thread` keeps one thread's spans."""
        child = self._child_ns()
        out = {}
        for s in self.spans:
            if thread is None or s.thread == thread:
                out[s.name] = out.get(s.name, 0) + (
                    s.t1 - s.t0 - child.get(s.id, 0))
        return {k: v / 1e6 for k, v in out.items()}

    def total_ms(self, thread=None):
        """{name: summed duration in ms}, child spans included."""
        out = {}
        for s in self.spans:
            if thread is None or s.thread == thread:
                out[s.name] = out.get(s.name, 0) + s.t1 - s.t0
        return {k: v / 1e6 for k, v in out.items()}

    def calls(self, thread=None):
        out = {}
        for s in self.spans:
            if thread is None or s.thread == thread:
                out[s.name] = out.get(s.name, 0) + 1
        return out

    def by_frame(self):
        """{frame id: {name: self ms}}, frames in the order they began."""
        child = self._child_ns()
        out = {}
        for s in sorted(self.spans, key=lambda s: s.t0):
            if s.frame is not None:
                row = out.setdefault(s.frame, {})
                row[s.name] = row.get(s.name, 0.0) + (
                    s.t1 - s.t0 - child.get(s.id, 0)) / 1e6
        return out


def launch_wrappers():
    """The kernel wrappers of LAUNCH_COUNTERS, in its order."""
    pkg = __name__.rpartition(".")[0]
    return tuple(getattr(importlib.import_module(f"{pkg}.{mod}"), attr)
                 for _, mod, attr in LAUNCH_COUNTERS)


def launch_counts():
    """{"K1": launches, ...} of the kernel wrappers, now."""
    return {k: w.launches for (k, _, _), w in zip(LAUNCH_COUNTERS,
                                                  launch_wrappers())}


@contextlib.contextmanager
def recording(sync=False):
    """Install a Recording for the `with` block (see the module's
    docstring); raises if one is installed already."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a trace recording is installed already")
    rec = Recording(sync)
    before = launch_counts()
    if rec.sync:
        rec._synchronize()
    rec.t0 = time.perf_counter_ns()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        if rec.sync:
            rec._synchronize()
        rec.t1 = time.perf_counter_ns()
        after = launch_counts()
        rec.launches = {k: after[k] - before[k] for k in after}


class StageTimer:
    """The tracer's marker mode: wall milliseconds per stage name, summed
    over frames, from `start()` and then from each mark to the next. Each
    mark ends with a torch.cuda.synchronize() on CUDA, so a stage holds
    its own device work; an encoder's `stages` hook takes one of these
    (any object with `start()` and `__call__(name)` will do)."""

    def __init__(self, device):
        import torch
        self._torch = torch
        self.device = torch.device(device)
        self.ms = {}
        self._t = None

    def _now(self):
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self):
        self._t = self._now()

    def __call__(self, name):
        t = self._now()
        self.ms[name] = self.ms.get(name, 0.0) + (t - self._t) * 1e3
        self._t = t
