"""What the per-layer metrics' readers (bench_port/metrics/<name>.py) share.
A reader returns None where the traced run has nothing for it, and the
harness then leaves the metric out of the result line."""
from __future__ import annotations


def stage_ms(t, labels):
    """Milliseconds per frame of the spanned window in the spans or stages
    named `labels`, summed; None where none of them ran."""
    if t is None or not t.frames:
        return None
    got = [t.spans[k] for k in labels if k in t.spans]
    return sum(got) / t.frames if got else None


def counter_ms(t, key):
    """A program counter's milliseconds per frame of the spanned window."""
    if t is None or not t.frames or key not in t.counters:
        return None
    return t.counters[key] / t.frames


def device_idle_pct(t):
    """Percent of the profiler window in which nothing ran on the device."""
    p = t.profile if t is not None else None
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def kernel_roofline_pct(t):
    """Percent: the least time the card could take for the profiled
    frames' stages' work (harness/workcounts) over the device time of
    every kernel in the profiler window."""
    p = t.profile if t is not None else None
    if p is None or not t.least_s or p.kernel_s <= 0:
        return None
    return 100.0 * t.least_s / p.kernel_s

