"""What the encode drivers share: the encoder of a configuration, the
stage clock and labels around the encoder's functions, the work counts
of its encodes, and the reference's check of an encoded stream."""
from __future__ import annotations

import inspect

import numpy as np

from harness import streams, trace, workcounts
from harness.runner import Check
from reference import check as ref

PAD = 32          # the encoder's reference padding (decoder_torch.PAD)
ME_RADIUS = 16    # TorchEncoder.ME_RADIUS


def make_encoder(config, device):
    """TorchEncoder of a configuration file's `encoder` settings, with the
    rate controller of its `rc` entry (a ratectl class by name)."""
    from losslessh264_tpu_torch import ratectl
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    kw = dict(config["encoder"])
    if config.get("rc"):
        spec = dict(config["rc"])
        kw["rc"] = getattr(ratectl, spec.pop("kind"))(
            spec.pop("bitrate_bps"), spec.pop("fps"), **spec)
    return TorchEncoder(config["width"], config["height"], device=device,
                        **kw)


def param_sets(first_frame):
    """The NAL units before the first slice of a stream's first access
    unit (its SPS and PPS), to put before a later IDR's bytes."""
    for start, kind, _ in streams.nal_units(first_frame):
        if kind in streams.VCL:
            return first_frame[:start]
    return b""


# labels of the encoder's functions in a profiler window: what the host
# was doing while the device idled
ENCODE_LABELS = (
    ("encoder_torch.TorchEncoder", "encode_frames", "encode_frames"),
    ("encoder_torch.TorchEncoder", "encode_frame", "encode_frame"),
    ("encoder_torch.TorchEncoder", "_upload", "upload"),
    ("encoder_torch.TorchEncoder", "_denoise", "analyses"),
    ("processing", "scene_change_score", "analyses"),
    ("processing", "frame_complexity", "analyses"),
    ("processing", "scroll_detect", "analyses"),
    ("encoder_torch.TorchEncoder", "_qp_maps", "qp_maps"),
    ("encoder_torch.TorchEncoder", "_dispatch_p_run", "dispatch_run"),
    ("encoder_torch", "_p_analyze", "search_residual"),
    ("encoder_torch", "_p_finish", "deblock"),
    ("encoder_torch", "_p_intra_fixup", "intra_deblock"),
    ("encoder_torch", "_i_frame", "idr"),
    ("encoder_torch", "intra_wavefront", "intra"),
    ("encoder_torch.TorchEncoder", "_apply_deblock", "deblock"),
    ("encoder_native", "write_frame", "writer"),
)


def labels(sync):
    ins = trace.Instrument("labels", sync)
    for path, attr, label in ENCODE_LABELS:
        ins.wrap(trace.program_attr(path), attr, label)
    return ins


def stage_clock(enc, sync):
    """A StageClock on the encoder (`enc.stages`), and for the frames
    encode_frames chains in runs (which pass no stage function) the same
    clock handed to _p_analyze, _p_finish and _p_intra_fixup: a run's
    uploads count as `upload`, and the host's work between a frame's
    analysis and its finish (the intra mask's fetch, the rows' packing)
    as `fetch`. Returns (clock, undo)."""
    from losslessh264_tpu_torch import encoder_torch as et
    clock = trace.StageClock(sync)
    enc.stages = clock
    saved = {}
    state = {"first": False}

    def unstaged(fn, args, kwargs):
        return "stage" not in inspect.signature(fn).bind(
            *args, **kwargs).arguments

    def wrap(name, before):
        fn = getattr(et, name, None)
        if fn is None:
            return
        saved[name] = fn

        def staged(*args, **kwargs):
            if unstaged(fn, args, kwargs):
                before()
                kwargs["stage"] = clock
            return fn(*args, **kwargs)
        setattr(et, name, staged)

    def analyze_before():
        clock("upload" if state["first"] else "fetch")
        state["first"] = False

    wrap("_p_analyze", analyze_before)
    wrap("_p_finish", lambda: clock("fetch"))
    wrap("_p_intra_fixup", lambda: clock("fetch"))
    dispatch = et.TorchEncoder.__dict__.get("_dispatch_p_run")
    if dispatch is not None:
        def dispatch_run(self, frames):
            clock.start()
            state["first"] = True
            try:
                return dispatch(self, frames)
            finally:
                clock("fetch")
        et.TorchEncoder._dispatch_p_run = dispatch_run

    def undo():
        enc.stages = None
        for name, fn in saved.items():
            setattr(et, name, fn)
        if dispatch is not None:
            et.TorchEncoder._dispatch_p_run = dispatch
    return clock, undo


def least_seconds(encodes, width, height):
    """The least seconds the card could take for the stages' work of the
    encodes listed (TorchEncoder.encodes entries: kind "I" or "P", path,
    is_ref, intra MBs), counted per frame from its size: an IDR's intra
    wavefront (K4's count); a P frame's dense search (K5's, at the int8
    rate), half-pel planes of its reference (K1's), residual (K8's count
    without its chroma reference samples, which need the frame's MVs: a
    lower bound) and the intra wavefront of its intra MBs; every frame's
    deblock (K9's tables, rows and four planes, a lower bound, and
    K2's)."""
    mb_w, mb_h = -(-width // 16), -(-height // 16)
    H, W, n = 16 * mb_h, 16 * mb_w, mb_w * mb_h
    total = 0.0
    for kind, _path, _is_ref, n_intra in encodes:
        if kind == "I":
            n_intra = n
        else:
            b, o = workcounts.k5_bytes_ops(H, W, ME_RADIUS, 1)
            total += workcounts.least_s(b, o, workcounts.INT8_OPS_PER_S)
            total += workcounts.least_s(
                workcounts.k1_bytes(H + 2 * PAD, W + 2 * PAD, "u8"), 0)
            k8_bytes = (H * W * 3 // 2 + 4 * (256 * n + 13 * n)
                        + n * (2 + 4 * 785))
            total += workcounts.least_s(
                k8_bytes, workcounts.K8_OPS_PER_SAMPLE * 384 * n)
        if n_intra:
            total += workcounts.least_s(
                workcounts.k4_bytes(mb_w, mb_h, n_intra),
                n_intra * workcounts.K4_OPS_PER_MB)
        k9_bytes = (workcounts.K9_TABLE_BYTES
                    + 4 * n * workcounts.DEBLOCK_PACK_WIDTH
                    + n * (4 + 4 + 16 + 128))
        total += workcounts.least_s(k9_bytes,
                                    workcounts.K9_OPS_PER_MB * n)
        total += workcounts.least_s(workcounts.k2_bytes(mb_w, mb_h), 0)
    return total


def check_stream(stream, expected_frames, sample, picture, sources,
                 mse_limit):
    """The reference's checks of an encoded stream.

    stream: its bytes from the first IDR on (parameter sets first);
    expected_frames: the frames the encoder returned bytes for;
    sample: the index of the frame the numpy decoder reconstructs (None:
    none), from the program's decoded picture of each frame it names,
    `picture(i)` -> (Y, U, V) (the program's state, which the reference
    follows one step), to equal the program's own picture of the frame;
    sources: [(i, picture, source)] of frames whose picture is held
    against its source (luma MSE). Returns the Checks."""
    n, damaged, kept = ref.parse(stream, keep=(sample,))
    undecodable = abs(n - expected_frames) + damaged
    if sample is None:
        mismatch = 0
    elif sample in kept:
        got = ref.recon(kept[sample], picture)
        mismatch = ref.mismatched(got, picture(sample))
    else:
        mismatch = sum(np.asarray(a).size for a in picture(sample))
    worst = max((ref.mse(pic, src) for _, pic, src in sources), default=0.0)
    return [Check("undecodable_frames", undecodable, 0),
            Check("reference_mismatch", mismatch, 0),
            Check("worst_luma_mse", worst, mse_limit)]


def plant(fault, enc):
    """Break the encode path underneath (the benchmark's tests): returns
    the function that undoes it."""
    from losslessh264_tpu_torch import encoder_native, encoder_torch as et
    from losslessh264_tpu_torch.ops import deblock as tdb
    saved_mod = {k: getattr(et, k) for k in ("_deblock_recon", "_p_batch")}
    saved_planes = tdb.deblock_planes
    saved_write = encoder_native.write_frame
    saved_encode = et.TorchEncoder.encode_frame
    if fault == "control":
        # the recon left unfiltered, where the stream says the in-loop
        # filter is on
        def unfiltered(mb_w, mb_h, recY, recU, recV, *a, **k):
            return recY, recU, recV
        et._deblock_recon = unfiltered
    elif fault == "stale_state":
        # each step hands back the reference state it was given
        p_batch = saved_mod["_p_batch"]

        def stale_batch(mb_w, mb_h, radius, idc, bufs, refY, refU, refV,
                        *a, **k):
            rows, _ = p_batch(mb_w, mb_h, radius, idc, bufs, refY, refU,
                              refV, *a, **k)
            return rows, (refY, refU, refV)
        et._p_batch = stale_batch

        def stale_encode(self, *a, **k):
            before = self.ref
            data = saved_encode(self, *a, **k)
            if before is not None:
                self.ref = before
            return data
        et.TorchEncoder.encode_frame = stale_encode
    elif fault == "alter_output":
        # one coefficient of every frame altered as the writer gets it
        def altered(*a, **k):
            k = dict(k)
            lac = np.array(k["luma_ac"], np.int16, copy=True)
            lac.reshape(-1)[1] += 1
            k["luma_ac"] = lac
            return saved_write(*a, **k)
        encoder_native.write_frame = altered
    elif fault == "shared_filter":
        # the in-loop filter left out in the deblock code that the encoder
        # and the decoder share: the two agree, the stream's reference not
        tdb.deblock_planes = lambda mb_w, mb_h, Yw, Uw, Vw, *a, **k: (
            Yw, Uw, Vw)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")

    def undo():
        tdb.deblock_planes = saved_planes
        for k, v in saved_mod.items():
            setattr(et, k, v)
        encoder_native.write_frame = saved_write
        et.TorchEncoder.encode_frame = saved_encode
    return undo
