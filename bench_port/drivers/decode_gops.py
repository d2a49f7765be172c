"""Closed-loop decode in GOP passes: each pass decodes one whole GOP of a
stream from its IDR, with the stream's parameter sets in front
(harness/gops.py), through a fresh TorchDecoder, as a player that seeks
to an IDR or a GOP-sharded worker does; the next pass starts as soon as
the last frame of the one before is out.

Traffic keys: `stream` (bench_port/data/<stream>.264, with NpDecoder's
CRCs of every frame in reference/crc/<stream>.json), `warmup_gop`: the
GOP the set-up decodes; `trace_frames`: the frames of a traced run's
profiler window; `check_share`: the share of the window's passes, drawn
from the seed, whose frames are kept for the check (and the window's
first pass). Every cycle of passes decodes each GOP once, in an order
drawn from the seed.

The window, the check and the faults are decode_closed's: decode_fps is
every frame TorchDecoder.frames() yielded in the window over the
window's seconds; correct holds every frame of the sampled passes to
NpDecoder's CRC32 for its place in the stream (crc_mismatch), and every
pass the window finished to its whole GOP (short_passes). A traced run
adds, to decode_closed's stage labels, `cells` on the per-cell MC route
(decoder_torch._mc_legacy_cells, and _mc_cells where the program has
it); keeps the program's own counters over the spanned window
(TraceData.counters); counts K11's work on the profiled frames that take
the per-cell route in least_s (harness/workcounts_cells.py), and apart
in `cells_least_s` beside the profiler window's K11 device time
(`profile.cells_kernel_s`).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from harness import (clock, gops, spec, trace, workcounts,
                     workcounts_cells)
from harness.runner import Check, Outcome, TraceData
from reference import check as ref

# decode_closed's stages, window arithmetic, faults and work counts
closed = spec.load_module(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "decode_closed.py"), "bench_gops_closed")

# the per-cell route: (owner path, attribute, label, absorb); a name the
# program does not have is skipped
CELL_STAGES = (
    ("decoder_torch", "_mc_legacy_cells", "cells", False),
    ("decoder_torch", "_mc_cells", "cells", False),
)
K11_KERNEL = "mc_cells_kernel"   # csrc/mc_cells.cu's kernel, by name
PAD = 32                         # decoder_torch.PAD: the rings' luma padding


def instrument(mode, sync, on_planes=None, on_deblock=None):
    ins = closed.instrument(mode, sync, on_planes, on_deblock)
    for path, attr, label, absorb in CELL_STAGES:
        ins.wrap(trace.program_attr(path), attr, label, absorb)
    return ins


@contextlib.contextmanager
def program_counters():
    """The program's own counters over the `with` block (a recording of
    its tracer)."""
    from losslessh264_tpu_torch import trace as program
    out = {}
    with program.recording(sync=False) as rec:
        yield out
    out.update(rec.counters)


def profile_window(fn, sync):
    """trace.profile_window, keeping the device time of K11's launches as
    the Profile's `cells_kernel_s`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        window_s = time.perf_counter() - t0
    events = prof.events()
    out = trace.Profile(events, window_s)
    out.cells_kernel_s = sum(
        e.time_range.end - e.time_range.start for e in events
        if e.device_type == DeviceType.CUDA and K11_KERNEL in e.name) / 1e6
    return result, out


def run(ctx):
    import torch
    from losslessh264_tpu_torch import decoder_torch as dt
    t = ctx.cell.traffic
    device = ctx.device
    sync = ctx.sync
    with open(os.path.join(ctx.root, "bench_port", "data",
                           t["stream"] + ".264"), "rb") as fh:
        data = fh.read()
    clips = gops.gop_clips(data)
    starts, n_frames = gops.gop_starts(data)
    sizes = [b - a for a, b in zip(starts, starts[1:] + [n_frames])]
    rng = np.random.default_rng(ctx.seed)
    # set-up: one pass of a GOP builds and loads the kernels and the
    # native layer and warms every route the passes take
    for _ in dt.TorchDecoder(clips[int(t["warmup_gop"])][1],
                             device=device).frames():
        pass
    sync()
    undo = closed.plant(ctx.fault)

    stamps = []   # each frame's time out, from the window's start
    share = float(t["check_share"])
    pick = np.random.default_rng([ctx.seed, 2])

    def order():
        while True:
            yield from (int(g) for g in rng.permutation(len(clips)))

    def window(seconds, gop_order, kept, max_frames=None):
        """Decode GOP passes until `seconds` pass (or `max_frames`
        frames): (frames, seconds, short passes). The frames of a share
        of the passes, drawn from the seed, go to `kept` (with their
        place in the stream) for the check."""
        frames = short = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        done = False
        while not done:
            g = next(gop_order)
            first, clip = clips[g]
            k = 0
            sample = kept is not None and (not kept
                                           or pick.random() < share)
            for Y, U, V in dt.TorchDecoder(clip, device=device).frames():
                if sample:
                    kept.append((first + k, Y, U, V))
                k += 1
                frames += 1
                now = time.perf_counter()
                stamps.append(now - t0)
                if now >= deadline or (max_frames and frames >= max_frames):
                    done = True
                    break
            short += (not done and k < sizes[g])
        sync()
        return frames, time.perf_counter() - t0, short

    gop_order = order()
    kept = []
    spans = None
    counters = contextlib.nullcontext({})
    if ctx.trace:
        spans = instrument("spans", sync)
        counters = program_counters()
    setup_bytes = torch.cuda.max_memory_allocated() if device == "cuda" \
        else 0
    sync()
    t_start = time.perf_counter()
    try:
        with clock.GcClock() as gcc, clock.HostClock() as host, \
                counters as program:
            frames, window_s, short = window(ctx.seconds, gop_order, kept)
    finally:
        if spans is not None:
            spans.restore()
    gaps = np.diff([0.0] + stamps[:frames])
    notes = [closed.per_second(stamps[:frames], window_s), gcc.line(),
             host.line(),
             f"frames kept for the check: {len(kept)}; device memory "
             f"after set-up: {setup_bytes} bytes",
             f"the longest wait for a frame: {gaps.max() * 1e3:.1f} ms "
             f"at {stamps[int(gaps.argmax())]:.3f} s"]
    out_trace = profile = None
    if ctx.trace:
        planes, deblocked = [], set()
        labels = instrument(
            "labels", sync, on_planes=lambda a, k, r: planes.append(r),
            on_deblock=lambda a, k, r: deblocked.add(id(a[5])))
        try:
            _, profile = profile_window(
                lambda: window(1e9, gop_order, None,
                               max_frames=t["trace_frames"]), sync)
        finally:
            labels.restore()
        mb_w, mb_h = closed.geometry(clips[0][1])
        H, W = 16 * mb_h, 16 * mb_w
        ring = (closed.RING_SLOTS, H + 2 * PAD, W + 2 * PAD)
        ring_u = (closed.RING_SLOTS, H // 2 + PAD, W // 2 + PAD)
        cells_least = sum(
            workcounts.least_s(*workcounts_cells.k11_bytes_ops(
                ring, ring_u, PAD, p, mb_w, mb_h))
            for p in planes
            if p.get("mc_any", False) and not p.get("mc_fast", True))
        out_trace = TraceData(
            spans=spans.ms, frames=frames, profile=profile,
            least_s=closed.least_seconds(planes, deblocked, mb_w, mb_h)
            + cells_least, counters=dict(program))
        out_trace.cells_least_s = cells_least
        notes.append(f"program counters over the spanned window: "
                     f"{dict(sorted(program.items()))}")
        notes.append(f"profiler window: {len(planes)} frames, K11 device "
                     f"{profile.cells_kernel_s:.6f} s, its least "
                     f"{cells_least:.6f} s")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    undo()

    # the check, once the window has closed
    crcs = ref.stream_crcs(os.path.join(ctx.root, "bench_port", "reference",
                                        "crc", t["stream"] + ".json"))
    mismatch = 0
    for k, Y, U, V in kept:
        got = ref.frame_crc(*(a.cpu().numpy() for a in (Y, U, V)))
        mismatch += got != crcs[k]
    del kept
    checks = [Check("crc_mismatch", mismatch, 0),
              Check("short_passes", short, 0)]
    return Outcome(
        t_window_start=t_start, frames=frames, window_s=window_s,
        attempted=frames, failed=0,
        e2e={"decode_fps": frames / window_s}, checks=checks,
        memory_peak_bytes=peak, trace=out_trace, profile=profile,
        notes=notes)
