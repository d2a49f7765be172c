"""Spans and labels around the program's functions, found by name, and the
arithmetic of one torch.profiler window.

The benchmark records spans from its own files: it replaces a named
function of the program (a module attribute or a class attribute) by a
wrapper for the length of a window and puts the original back after it.
A name the program no longer has is skipped, and a metric that reads it
then finds nothing and is left out of the result line.
"""
from __future__ import annotations

import functools
import importlib
import threading
import time

LABEL_PREFIX = "bench:"
NAME_CHARS = 120   # a device operation's name in the breakdown, cut here


def program_attr(path):
    """The program's module or class at `path`, relative to the package:
    "decoder_torch", "decoder_torch.TorchDecoder"."""
    mod, _, attr = path.partition(".")
    obj = importlib.import_module("losslessh264_tpu_torch." + mod)
    return getattr(obj, attr) if attr else obj


class Instrument:
    """Wrappers around named functions, in one of two modes.

    "spans": host wall time of each call between two device synchronizes
    (so a span holds its own device work), summed per label as self time:
    a span's time less that of the spans it encloses. A label opened with
    absorb=True keeps the time of everything it encloses. Only the
    thread that made the Instrument records; calls from other threads
    pass through untouched.

    "labels": a torch.profiler.record_function range per call and no
    synchronize, so that a profiler window can tell what the host was
    doing in each idle gap of the device.

    `on_call(args, kwargs, result)`, where given, sees every call's
    arguments and result in either mode (the work counts read the
    frames' symbol planes this way)."""

    def __init__(self, mode, sync=None):
        if mode not in ("spans", "labels"):
            raise ValueError(mode)
        self.mode = mode
        self.ms = {}
        self.calls = {}
        self._sync = sync or (lambda: None)
        self._stack = []
        self._main = threading.get_ident()
        self._undo = []
        self.missing = []

    def wrap(self, owner, attr, label, absorb=False, on_call=None):
        fn = owner.__dict__.get(attr) if isinstance(owner, type) else \
            getattr(owner, attr, None)
        if fn is None:
            self.missing.append(f"{getattr(owner, '__name__', owner)}.{attr}")
            return False
        if isinstance(fn, (staticmethod, classmethod)):
            raise TypeError(f"{attr}: wrap the function, not a descriptor")
        inner = self._timed if self.mode == "spans" else self._labelled

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            result = inner(fn, label, absorb, args, kwargs)
            if on_call is not None and threading.get_ident() == self._main:
                on_call(args, kwargs, result)
            return result

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, fn))
        return True

    def _timed(self, fn, label, absorb, args, kwargs):
        if (threading.get_ident() != self._main
                or (self._stack and self._stack[-1][2])):
            return fn(*args, **kwargs)
        self._sync()
        t0 = time.perf_counter()
        self._stack.append([label, 0.0, absorb])
        try:
            return fn(*args, **kwargs)
        finally:
            self._sync()
            total = (time.perf_counter() - t0) * 1e3
            _, child, _ = self._stack.pop()
            self.ms[label] = self.ms.get(label, 0.0) + total - child
            self.calls[label] = self.calls.get(label, 0) + 1
            if self._stack:
                self._stack[-1][1] += total

    def _labelled(self, fn, label, absorb, args, kwargs):
        if threading.get_ident() != self._main:
            return fn(*args, **kwargs)
        from torch.profiler import record_function
        with record_function(LABEL_PREFIX + label):
            return fn(*args, **kwargs)

    def restore(self):
        while self._undo:
            owner, attr, fn = self._undo.pop()
            setattr(owner, attr, fn)


class StageClock:
    """A stand-in for the encoder's StageTimer (encoder_torch.StageTimer:
    wall ms per stage name, each stage ending in a synchronize) that
    records only from the thread that made it: encode_frames writes its
    runs on a second thread, whose stage calls pass through here
    untimed. `start()` marks the start of a frame's first stage."""

    def __init__(self, sync):
        self.ms = {}
        self._sync = sync
        self._t = None
        self._main = threading.get_ident()

    def _now(self):
        self._sync()
        return time.perf_counter()

    def start(self):
        if threading.get_ident() == self._main:
            self._t = self._now()

    def __call__(self, name):
        if threading.get_ident() != self._main or self._t is None:
            return
        t = self._now()
        self.ms[name] = self.ms.get(name, 0.0) + (t - self._t) * 1e3
        self._t = t


class Profile:
    """The arithmetic of one profiler window (copied from the reading of
    chip_smoke.profile_report, which sums the device-side events, and
    extended to their union and to the host's idle gaps).

    busy_s: the union of the intervals in which a kernel, copy or set ran
    on the device; window_s: the window's wall seconds; kernel_s: the
    summed time of the kernels alone; ops: [name, seconds] of the device
    operations that took the most; idle: [label, seconds] of the device's
    idle time by the innermost label the host was inside at the middle
    of each gap ("unlabelled" outside every label). The labels' own
    ranges, which the profiler also puts on the device's timeline, are
    no device work."""

    def __init__(self, events, window_s, top=10):
        from torch.autograd import DeviceType
        dev, labels = [], []
        t_lo, t_hi = None, None
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                # the labels' ranges show on the device's timeline too
                if t > s and not e.name.startswith(LABEL_PREFIX):
                    dev.append((s, t, e.name))
            else:
                t_lo = s if t_lo is None else min(t_lo, s)
                t_hi = t if t_hi is None else max(t_hi, t)
                if e.name.startswith(LABEL_PREFIX):
                    labels.append((s, t, e.name[len(LABEL_PREFIX):]))
        self.window_s = window_s
        per_op = {}
        kernel_us = 0.0
        for s, t, name in dev:
            per_op[name] = per_op.get(name, 0.0) + (t - s)
            if not name.startswith(("Memcpy", "Memset")):
                kernel_us += t - s
        self.kernel_s = kernel_us / 1e6
        self.ops = [[n[:NAME_CHARS], us / 1e6] for n, us in
                    sorted(per_op.items(), key=lambda kv: -kv[1])[:top]]
        union = []
        for s, t, _ in sorted(dev):
            if union and s <= union[-1][1]:
                union[-1][1] = max(union[-1][1], t)
            else:
                union.append([s, t])
        self.busy_s = sum(t - s for s, t in union) / 1e6
        gaps = []
        if union and t_lo is not None:
            edges = [t_lo] + [x for iv in union for x in iv] + [t_hi]
            gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        idle = {}
        for (a, b), label in zip(gaps, innermost(labels,
                                                 [(a + b) / 2 for a, b in gaps])):
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        self.idle = [[n, s] for n, s in
                     sorted(idle.items(), key=lambda kv: -kv[1])[:top]]


def innermost(intervals, points):
    """For each of the ascending `points`, the name of the innermost of
    the properly nested `intervals` (start, end, name) that holds it, or
    "unlabelled"."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    stack, out, k = [], [], 0
    for p in points:
        while k < len(ivs) and ivs[k][0] <= p:
            while stack and stack[-1][1] < ivs[k][0]:
                stack.pop()
            stack.append(ivs[k])
            k += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "unlabelled")
    return out


def profile_window(fn, sync):
    """Run fn() under torch.profiler (CPU and CUDA activities) and return
    (fn's result, Profile)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        window_s = time.perf_counter() - t0
    return result, Profile(prof.events(), window_s)
