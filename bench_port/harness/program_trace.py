"""The program's own spans and counters (losslessh264_tpu_torch/trace.py),
read in two passes over a window, with the benchmark's wrappers already
put back:

1. a recording without the profiler: ms per frame of each span's self
   time and each counter per frame, divided by the program's own frame
   counter (`dec.frames`, `enc.frames`); the frames per second of the
   pass, beside the untraced window's, is what the recording costs;
2. on a CUDA machine, a recording under torch.profiler: the device's
   idle time put down, moment by moment, to the innermost program span
   that the thread issuing the device work was inside (a gap that spans
   the symbol decode and the plan is split between them; the gap's
   middle alone would give it all to one short step). The spans'
   record_function ranges (names that start with the program's prefix)
   also show on the device's timeline, and are left out of its busy
   union, as are the benchmark's own labels.

    pt = program_trace.passes(lambda: window(...), "dec.frames", sync)
    span_ms(pt, ("dec.upload",))          # ms per frame
    idle_pct(pt, ("dec.plan", "dec.upload"))

A checkout whose program has no tracer gives None, and every reading of
it None.
"""
from __future__ import annotations

import importlib
import threading
import time
from dataclasses import dataclass, field

from . import trace as bench_trace

# names of a frame's or a run's top-level span: idle under one of these
# (or outside every span) is not put down to a step of the frame
FRAME_SPANS = ("dec.frame", "enc.frame", "enc.run")


@dataclass
class ProgramTrace:
    """frames: the program's frames in pass 1; wall_s: its seconds;
    self_ms: {name: self ms} over pass 1, every thread; main_ms: the
    same on the thread that ran the window; counters: pass 1's; idle_s:
    {innermost span name or "unlabelled": seconds} of the device's idle
    time in pass 2; busy_s, window_s: pass 2's busy union and wall
    seconds (empty and 0 without a card)."""
    frames: int
    wall_s: float
    self_ms: dict
    main_ms: dict
    counters: dict
    idle_s: dict = field(default_factory=dict)
    busy_s: float = 0.0
    window_s: float = 0.0


def program():
    """The program's tracer module, or None where it has none."""
    try:
        mod = importlib.import_module("losslessh264_tpu_torch.trace")
    except ImportError:
        return None
    return mod if hasattr(mod, "recording") else None


def passes(run, frame_counter, sync):
    """Run `run()` twice as set out in the module's docstring and return
    a ProgramTrace (None where the program has no tracer)."""
    tr = program()
    if tr is None:
        return None
    sync()
    t0 = time.perf_counter()
    with tr.recording() as rec:
        run()
        sync()
    wall_s = time.perf_counter() - t0
    main = threading.get_ident()
    pt = ProgramTrace(
        frames=int(rec.counters.get(frame_counter, 0)), wall_s=wall_s,
        self_ms=rec.self_ms(), main_ms=rec.self_ms(thread=main),
        counters=dict(rec.counters))
    import torch
    if not torch.cuda.is_available():
        return pt
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tr.recording():
            t0 = time.perf_counter()
            run()
            sync()
            pt.window_s = time.perf_counter() - t0
    pt.idle_s, pt.busy_s = idle_by_span(prof.events(), tr.PREFIX)
    return pt


def idle_by_span(events, prefix):
    """({innermost program span or "unlabelled": idle seconds}, busy
    seconds) of a profiler window's events. The device's busy time is
    the union of its kernels, copies and sets (the program's and the
    benchmark's ranges on its timeline left out); the idle gaps run from
    the first host event to the last. The spans are those of the host
    thread that holds the frames' top-level spans (the one issuing the
    device work; the encoder's writer thread holds none)."""
    from torch.autograd import DeviceType
    dev, ranges = [], {}
    t_lo = t_hi = None
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if t > s and not e.name.startswith(
                    (prefix, bench_trace.LABEL_PREFIX)):
                dev.append((s, t))
            continue
        t_lo = s if t_lo is None else min(t_lo, s)
        t_hi = t if t_hi is None else max(t_hi, t)
        if e.name.startswith(prefix):
            ranges.setdefault(e.thread, []).append(
                (s, t, e.name[len(prefix):]))
    union = []
    for s, t in sorted(dev):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], t)
        else:
            union.append([s, t])
    busy_s = sum(t - s for s, t in union) / 1e6
    if not union or t_lo is None:
        return {}, busy_s
    edges = [t_lo] + [x for iv in union for x in iv] + [t_hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    issuing = max(ranges.values(), default=[], key=lambda rs: sum(
        n in FRAME_SPANS for _, _, n in rs))
    idle = {}
    for a, b, name in overlaps(gaps, innermost_segments(issuing)):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return idle, busy_s


def innermost_segments(intervals):
    """The timeline cut where any of the properly nested `intervals`
    (start, end, name) starts or ends: [(start, end, the innermost name
    there)], in order, gaps between them left out."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    bounds = sorted({x for s, t, _ in ivs for x in (s, t)})
    segs, stack, k = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while stack and stack[-1][1] <= a:
            stack.pop()
        while k < len(ivs) and ivs[k][0] <= a:
            stack.append(ivs[k])
            k += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        if stack:
            segs.append((a, b, stack[-1][2]))
    return segs


def overlaps(gaps, segs):
    """The ascending, disjoint `gaps` (a, b) cut by the ascending named
    `segs`: [(start, end, name)], "unlabelled" where no segment is."""
    out, k = [], 0
    for a, b in gaps:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        t, j = a, k
        while t < b:
            if j < len(segs) and segs[j][0] < b:
                s0, s1, name = segs[j]
                if s0 > t:
                    out.append((t, s0, "unlabelled"))
                    t = s0
                out.append((t, min(s1, b), name))
                t = min(s1, b)
                j += 1
            else:
                out.append((t, b, "unlabelled"))
                t = b
    return out


def span_ms(pt, names, thread="all"):
    """ms per frame of the spans `names` (self time), summed; `thread`
    "all", "main" (the thread that ran the window) or "other"."""
    if pt is None or not pt.frames:
        return None
    table = {"all": pt.self_ms, "main": pt.main_ms,
             "other": {k: v - pt.main_ms.get(k, 0.0)
                       for k, v in pt.self_ms.items()}}[thread]
    got = [table[n] for n in names if n in table]
    return sum(got) / pt.frames if got else None


def counter_per_frame(pt, name, scale=1.0):
    if pt is None or not pt.frames or name not in pt.counters:
        return None
    return pt.counters[name] * scale / pt.frames


def idle_pct(pt, prefixes):
    """Percent of pass 2's window in which the device idled while the
    innermost program span was one of `prefixes` or a span below one."""
    if pt is None or pt.window_s <= 0 or not pt.idle_s:
        return None
    s = sum(v for k, v in pt.idle_s.items()
            if any(k == p or k.startswith(p + ".") for p in prefixes))
    return 100.0 * s / pt.window_s


def named_idle_share(pt):
    """Percent of the device's idle time in pass 2 that falls inside a
    program span below a frame's or a run's top-level span."""
    if pt is None or not pt.idle_s:
        return None
    total = sum(pt.idle_s.values())
    named = sum(v for k, v in pt.idle_s.items()
                if k not in FRAME_SPANS and k != "unlabelled")
    return 100.0 * named / total if total > 0 else None
