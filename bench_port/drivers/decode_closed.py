"""Closed-loop decode: passes over a clip of a stream, each with a fresh
TorchDecoder, the next pass as soon as the last frame of the one before
is out.

Traffic keys: `stream` (bench_port/data/<stream>.264, with NpDecoder's
CRCs in reference/crc/<stream>.json), `clip_frames` [lo, hi]: every
cycle of passes decodes each clip length lo..hi once, in an order drawn
from the seed; `trace_frames`: the frames of a traced run's profiler
window; `check_share`: the share of the window's passes, drawn from the
seed, whose frames are kept for the check (and the window's first pass).

decode_fps: every frame TorchDecoder.frames() yielded in the window over
the window's seconds; the window closes at the first frame out after
`--seconds`, with a synchronize. correct: every frame of the sampled
passes has NpDecoder's CRC32 for its place in the stream (crc_mismatch),
and every pass the window finished yielded its whole clip
(short_passes). The other frames are dropped as they come, as a
consumer that writes them out would.
"""
from __future__ import annotations

import os
import time

import numpy as np

from harness import clock, streams, trace, workcounts
from harness.runner import Check, Outcome, TraceData
from reference import check as ref

# decoder_torch's functions per stage (dec.* metrics); a batch of all-
# intra frames is one recon_intra_batch call, counted whole as intra
DECODE_STAGES = (
    # (owner path, attribute, label, absorb)
    ("native.SymbolDecoder", "__next__", "symbols", False),
    ("decoder_torch.TorchDecoder", "_prep_refs", "plan", False),
    ("decoder_torch.TorchDecoder", "_prep_planes", "plan", False),
    ("decoder_torch", "planes_to_torch", "plan", False),
    ("decoder_torch", "_inter_pred", "inter", False),
    ("decoder_torch", "_residual_recon", "residual", False),
    ("decoder_torch", "_intra_scan", "intra", False),
    ("decoder_torch", "_intra_scan_sparse", "intra", False),
    ("decoder_torch", "recon_intra_batch", "intra", True),
    ("decoder_torch", "_deblock_crop", "deblock", False),
    ("decoder_torch", "_crop", "deblock", False),
    ("decoder_torch.TorchDecoder", "_finish_frame", "store", False),
    ("decoder_torch", "_store_ref", "store", False),
    ("decoder_torch", "_store_refs_k", "store", False),
)
RING_SLOTS = 19   # TorchDecoder.MAX_REFS + 1: the rings' slot count


def instrument(mode, sync, on_planes=None, on_deblock=None):
    ins = trace.Instrument(mode, sync)
    for path, attr, label, absorb in DECODE_STAGES:
        hook = None
        if attr == "planes_to_torch":
            hook = on_planes
        elif attr == "_deblock_crop":
            hook = on_deblock
        ins.wrap(trace.program_attr(path), attr, label, absorb, hook)
    return ins


def plant(fault):
    """Break the decode path underneath (the benchmark's tests): returns
    the function that undoes it."""
    from losslessh264_tpu_torch import decoder_torch as dt
    saved = {k: getattr(dt, k) for k in ("_deblock_crop", "_store_ref",
                                         "_store_refs_k", "_crop")}
    if fault == "control":
        # the in-loop filter left out, which the stream says is on
        dt._deblock_crop = lambda mb_w, mb_h, Yw, Uw, Vw, p: dt._crop(
            mb_w, mb_h, Yw, Uw, Vw)
    elif fault == "stale_state":
        # the ring store returns the reference state unchanged
        dt._store_ref = lambda *a, **k: None
        dt._store_refs_k = lambda *a, **k: None
    elif fault == "alter_output":
        crop = saved["_crop"]

        def altered(*a):
            Y, U, V = crop(*a)
            Y[0, 0] ^= 1
            return Y, U, V
        dt._crop = altered
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")

    def undo():
        for k, v in saved.items():
            setattr(dt, k, v)
    return undo


def geometry(data):
    """(mb_w, mb_h) of a stream's first frame, from the reference's
    symbol layer."""
    f = next(iter(ref.symbols.SymbolDecoder(data)))
    return f["mb_w"], f["mb_h"]


def run(ctx):
    import torch
    from losslessh264_tpu_torch import decoder_torch as dt
    t = ctx.cell.traffic
    device = ctx.device
    sync = ctx.sync
    with open(os.path.join(ctx.root, "bench_port", "data",
                           t["stream"] + ".264"), "rb") as fh:
        data = fh.read()
    offsets = streams.access_unit_offsets(data)
    lo, hi = t["clip_frames"]
    clips = {L: streams.clip(data, L, offsets) for L in range(lo, hi + 1)}
    rng = np.random.default_rng(ctx.seed)
    # set-up: one pass of the longest clip builds and loads the kernels
    # and the native layer and warms every shape the passes use
    for _ in dt.TorchDecoder(clips[hi], device=device).frames():
        pass
    sync()
    undo = plant(ctx.fault)

    stamps = []   # each frame's time out, from the window's start
    share = float(t["check_share"])
    pick = np.random.default_rng([ctx.seed, 2])

    def window(seconds, order, kept, max_frames=None):
        """Decode passes until `seconds` pass (or `max_frames` frames):
        (frames, seconds, short passes). The frames of a share of the
        passes, drawn from the seed, go to `kept` for the check."""
        frames = short = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        done = False
        while not done:
            L = next(order)
            k = 0
            # the window's first pass, then each with the share's chance
            sample = kept is not None and (not kept
                                           or pick.random() < share)
            for Y, U, V in dt.TorchDecoder(clips[L], device=device).frames():
                if sample:
                    kept.append((k, Y, U, V))
                k += 1
                frames += 1
                now = time.perf_counter()
                stamps.append(now - t0)
                if now >= deadline or (max_frames and frames >= max_frames):
                    done = True
                    break
            short += (not done and k < L)
        sync()
        return frames, time.perf_counter() - t0, short

    order = streams.clip_lengths(rng, lo, hi)
    kept = []
    spans = None
    if ctx.trace:
        spans = instrument("spans", sync)
    setup_bytes = torch.cuda.max_memory_allocated() if device == "cuda" \
        else 0
    sync()
    t_start = time.perf_counter()
    try:
        with clock.GcClock() as gcc, clock.HostClock() as host:
            frames, window_s, short = window(ctx.seconds, order, kept)
    finally:
        if spans is not None:
            spans.restore()
    gaps = np.diff([0.0] + stamps[:frames])
    notes = [per_second(stamps[:frames], window_s), gcc.line(),
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
            _, profile = trace.profile_window(
                lambda: window(1e9, order, None,
                               max_frames=t["trace_frames"]), sync)
        finally:
            labels.restore()
        out_trace = TraceData(
            spans=spans.ms, frames=frames, profile=profile,
            least_s=least_seconds(planes, deblocked, *geometry(clips[lo])))
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


def per_second(stamps, window_s):
    """A line of the frames out in each whole second of the window."""
    counts = np.bincount(np.asarray(stamps, np.float64).astype(np.int64),
                         minlength=int(window_s))
    return "frames out per second of the window: " + " ".join(
        str(int(c)) for c in counts)


def least_seconds(planes, deblocked, mb_w, mb_h):
    """The least seconds the card could take for the stages' work of the
    profiled frames, each frame counted from its symbol planes (the
    plane dicts planes_to_torch made): inter prediction (K6's and K1's
    counts on a frame the bucketed plan serves; nothing is counted for
    the per-cell route), residual (K7's), the intra pass (K3's, one
    frame at a time), and the deblock of the frames that were filtered
    (K9's and K2's)."""
    total = 0.0
    pad = 32
    H, W = 16 * mb_h, 16 * mb_w
    ring = (RING_SLOTS, H + 2 * pad, W + 2 * pad)
    ring_u = (RING_SLOTS, H // 2 + pad, W // 2 + pad)
    for p in planes:
        has_pred = bool(p.get("mc_any", False))
        if has_pred and p.get("mc_fast", False):
            total += workcounts.least_s(*workcounts.k6_bytes_ops(
                ring, ring_u, pad, p, mb_w, mb_h))
            total += int(p["mc_nslots"]) * workcounts.least_s(
                workcounts.k1_bytes(ring[1], ring[2], "u8"), 0)
        total += workcounts.least_s(*workcounts.k7_bytes_ops(
            mb_w, mb_h, p, has_pred))
        cls = p["mb_class"].cpu().numpy()
        n_intra = int(np.isin(cls, [0, 1, 2]).sum())
        if n_intra:
            total += workcounts.least_s(
                workcounts.k3_bytes(mb_w, mb_h, 1, n_intra),
                n_intra * workcounts.K3_OPS_PER_MB)
        if id(p) in deblocked:
            total += workcounts.least_s(*workcounts.k9_bytes_ops(
                mb_w, mb_h, [p[k] for k in (
                    "mb_class", "qp", "nnz", "mv", "ref_idx", "slice_id",
                    "deblock_idc", "alpha_off", "beta_off",
                    "transform8")]))
            total += workcounts.least_s(workcounts.k2_bytes(mb_w, mb_h), 0)
    return total

