"""Closed-loop offline encode: one TorchEncoder, called with one GOP of
frames at a time through encode_frames(frames, batch), the next call as
soon as the last returns.

Traffic keys: `gops` distinct GOPs of the seeded pan (harness/frames.py,
`patches_per_frame` intra patches a frame), cycled in an order drawn
from the seed; `batch` (encode_frames' run length); `trace_frames` (a
traced run's profiler window, whole GOPs); `mse_limit` (the worst luma
MSE of a decoded picture against its source that `correct` allows). The
GOP length is the configuration's IDR period (`encoder.gop`).

encode_fps: every frame whose Annex-B bytes a call returned in the
window, over the window's seconds; the window closes after the first
call that ends past `--seconds`, with a synchronize. correct: for each
distinct GOP, its first encode in the window: its stream parses
(undecodable_frames); the port's decoder decodes it to pictures held
against the sources (worst_luma_mse) and whose last equals the encoder's
recon (recon_mismatch); and, for one P frame of one GOP, both drawn from
the seed, the numpy decoder reconstructs that frame from the port
decoder's picture before it exactly as the port's decoder does
(reference_mismatch). The port's decoder only supplies that one
reference picture: the reference follows the program's state one step.
"""
from __future__ import annotations

import time

import numpy as np

from harness import clock, encoding, frames as gen, trace
from harness.runner import Check, Outcome, TraceData
from reference import check as ref


def run(ctx):
    import torch
    from losslessh264_tpu_torch.decoder_torch import TorchDecoder
    cfg, t = ctx.cell.config, ctx.cell.traffic
    device = ctx.device
    sync = ctx.sync
    gop = int(cfg["encoder"]["gop"])
    n_gops = int(t["gops"])
    batch = int(t["batch"])
    rng = np.random.default_rng(ctx.seed)
    W, H = cfg["width"], cfg["height"]
    plan = gen.patch_plan(rng, W, H, gop * n_gops,
                          int(t["patches_per_frame"]))
    src = gen.pan_frames(W, H, plan, seed=ctx.seed % 2 ** 32)
    gops = [src[g * gop:(g + 1) * gop] for g in range(n_gops)]

    def order():
        while True:
            yield from (int(g) for g in rng.permutation(n_gops))

    enc = encoding.make_encoder(cfg, device)
    # set-up: one GOP (the IDR, the runs of `batch` P frames and the
    # frames after the last full run) builds and warms every shape
    first = enc.encode_frames(gops[0], batch=batch)
    sync()
    params = encoding.param_sets(first[0])
    undo = encoding.plant(ctx.fault, enc)
    calls = []      # (gop, its frames' bytes, the encoder's last recon)
    call_ms = []

    def window(seconds, gop_order, max_frames=None, log=None):
        frames = 0
        t0 = time.perf_counter()
        while True:
            g = next(gop_order)
            t_call = time.perf_counter()
            data = enc.encode_frames(gops[g], batch=batch)
            call_ms.append((time.perf_counter() - t_call) * 1e3)
            calls.append((g, data, enc.ref))
            frames += len(data)
            if log is not None:
                log.extend(enc.encodes)
            if (time.perf_counter() - t0 >= seconds
                    or (max_frames and frames >= max_frames)):
                break
        sync()
        return frames, time.perf_counter() - t0, t0

    gop_order = order()
    stages = spans_undo = None
    prof0 = dict(enc.prof)
    if ctx.trace:
        stages, spans_undo = encoding.stage_clock(enc, sync)
    sync()
    try:
        with clock.HostClock() as host:
            frames, window_s, t_start = window(ctx.seconds, gop_order)
    finally:
        if spans_undo is not None:
            spans_undo()
    counters = {k: enc.prof[k] - prof0[k] for k in prof0}
    n_calls = len(calls)
    out_trace = profile = None
    if ctx.trace:
        encodes = []
        labels = encoding.labels(sync)
        try:
            _, profile = trace.profile_window(
                lambda: window(1e9, gop_order, int(t["trace_frames"]),
                               encodes), sync)
        finally:
            labels.restore()
        out_trace = TraceData(
            spans=dict(stages.ms), frames=frames, profile=profile,
            counters=counters,
            least_s=encoding.least_seconds(encodes, W, H))
    del calls[n_calls:]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # the check, once the window has closed: each distinct GOP's first
    # encode of the window
    firsts = {}
    for g, data, last in calls:
        firsts.setdefault(g, (data, last))
    totals = {"undecodable_frames": 0, "recon_mismatch": 0,
              "reference_mismatch": 0}
    worst = 0.0
    pick = np.random.default_rng([ctx.seed % 2 ** 63, 1])
    sampled = sorted(firsts)[int(pick.integers(len(firsts)))]
    # a P frame of that GOP: frames 1 .. gop - 1, most of them written
    # in runs of `batch`
    frame = int(pick.integers(1, gop))
    for g, (data, last) in sorted(firsts.items()):
        stream = params + b"".join(data)
        pics = [tuple(a.cpu().numpy() for a in p)
                for p in TorchDecoder(stream, device=device).frames()]
        last = tuple(a.cpu().numpy() for a in last)
        if len(pics) != len(data):
            totals["undecodable_frames"] += abs(len(data) - len(pics))
            pics = pics + [last] * max(0, len(data) - len(pics))
        for c in encoding.check_stream(
                stream, len(data), frame if g == sampled else None,
                lambda i: pics[i],
                [(i, pics[i], gops[g][i]) for i in range(len(data))],
                float(t["mse_limit"])):
            if c.name in totals:
                totals[c.name] += c.value
            else:
                worst = max(worst, c.value)
        totals["recon_mismatch"] += ref.mismatched(pics[-1], last)
    # a planted fault stays in the program until its decoder has run
    undo()
    checks = [Check(k, v, 0) for k, v in totals.items()]
    checks.append(Check("worst_luma_mse", worst, float(t["mse_limit"])))
    notes = [f"GOP calls in the window: {n_calls} of {gop} frames "
             f"(batch {batch}); checked GOPs {sorted(firsts)}, the numpy "
             f"decoder on frame {frame} of GOP {sampled}",
             "ms per GOP call: " + " ".join(
                 f"{x:.1f}" for x in call_ms[:n_calls]),
             f"writer thread ms {counters.get('entropy_ms')}, "
             f"ms waited for it {counters.get('writer_wait_ms')}",
             host.line()]
    return Outcome(
        t_window_start=t_start, frames=frames, window_s=window_s,
        attempted=frames, failed=0, e2e={"encode_fps": frames / window_s},
        checks=checks, memory_peak_bytes=peak, trace=out_trace,
        profile=profile, notes=notes)
