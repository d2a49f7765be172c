#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU (run from the repo root).

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):
  1. device: the card's name and power limit (nvidia-smi), torch's name.
  2. build: nvcc compiles losslessh264_tpu_torch/csrc/*.cu for sm_90a.
  3. K1 (csrc/halfpel.cu) against its plain torch version on the card,
     both entries, exact (torch.equal): edge-padded 720p planes
     (784x1344, random and frame 0 of tests/data/synth720p.264), 1080p
     (1152x1984) and 2160p (2224x3904) planes, a misaligned pointer and
     widths around one 128-column strip (Wp 132-134) that take the
     kernel's byte loads, a ragged aligned width and odd sizes; the uint8
     entry must hand back the 16-byte row pitch. The conv2d yardstick
     (k1_conv2d) must equal the plain version at the three sizes.
  4. K2 (csrc/deblock.cu) against its plain version on the card: block
     noise planes and random symbol planes on 9x4 .. 80x45 MBs x 2
     seeds, and 120x68 (1080p), 4x150 (more MB rows than SMs), 1x9 and
     2x7; 20 launches per case, each exact against the plain result.
  5. decode: all 25 frames of synth720p with TorchDecoder(device="cuda");
     every frame's CRC32 of Y|U|V must equal the committed NpDecoder
     goldens (tests/data/synth720p_np_crc.json), K1 must launch, and K2
     must launch exactly once per frame that is deblocked.
  6. times: K1 at 720p, 1080p and 2160p, both entries, wrapper and
     kernel alone, beside their bounds, its plain version and the conv2d
     yardstick; K2 against its plain version at 720p (CUDA events); a
     per-stage breakdown of every frame (deblock split into edge
     parameters, K2 and crop); then torch.profiler windows (P frames
     1-3, intra frame 10) with the device busy share. A profiler session
     slows the host's launches after it, so the windows come last.

The line before the last is the kernel report
{"kernels": [{"name", "route", "source", "replaces", "launches",
"launches_per_decode", "max_abs_err", "ms", "plain_ms", "bound_ms",
"bound_by", "library_ms"}, ...]}, preceded by the card line. For K1:
`ms`, `kernel_ms`, `bound_ms` and `bound_by` are its int32 entry's at
720p, and `ms_uint8_entry`, `kernel_ms_uint8_entry` and
`bound_ms_uint8_entry` those of the uint8 entry that the decode path
calls. `ms` is the wrapper, timed by CUDA events around 50 back-to-back
calls (the host's issue rate enters it); `kernel_ms` is the kernel
alone: CUDA events around the replays of a CUDA graph of at least 30
captured launches of the bare C entry, each on buffers that are no
longer in L2 (kernel_device_ms, k1_calls), so it holds the graph's gap
between two kernels but not the host. `library_ms` is the conv2d
yardstick at 720p (k1_conv2d: F.conv2d in float32 with TF32 off, then a
rounding pass). `sizes` holds, for "720p", "1080p" and "2160p", `ms_i32`,
`ms_u8`, `kernel_ms_i32`, `kernel_ms_u8`, `bytes_*`, `bound_ms_*`,
`bound_by_*`, `bound_share_*` (bound over kernel time), `plain_ms` and
`library_ms`. K2's `ms` is its wrapper (packing, plane copies, launch)
and `kernel_ms` the bare C entry by CUDA events, each launch on fresh
planes. The last line is {"ok": true, "device": {"platform": "gpu",
...}}. Without a GPU, or without the package beside it, the script
exits non-zero and prints no result.

Bounds: the larger of the bytes each kernel must move (every input read
once, every output written once) over 3.35 TB/s, and its integer
operations over 33.5 TOP/s (the H100 SXM's 67 TFLOP/s float32 rate
outside the tensor cores, halved: an SM has half as many int32 lanes as
float32 lanes). Both kernels are bound by bytes.
"""
import ctypes
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM = os.path.join(ROOT, "tests", "data", "synth720p.264")
GOLDEN = os.path.join(ROOT, "tests", "data", "synth720p_np_crc.json")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12     # see the module docstring
# K1's timed sizes: the edge-padded (PAD = 32) luma reference of 720p,
# 1080p (1088 coded rows) and 2160p
K1_SIZES = {"720p": (784, 1344), "1080p": (1152, 1984),
            "2160p": (2224, 3904)}
# 3 six-taps (b, h, j) of 11 ops, 3 round-and-clamps of 4 ops and the j
# pass over the b sums: ~50 int32 ops per output position
K1_OPS_PER_POSITION = 50


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def max_abs_err(x, y):
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max().item())


def bound_ms(n_bytes, n_ops):
    """(the least time the card could take, what bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms_each(fns, warmup=2):
    """Mean device time of one call of each of fns, called in turn, by
    CUDA events around all calls after the first `warmup`. For a kernel
    that works in place, each fn holds its own copy of the inputs, so
    every timed launch sees the inputs the parity check saw."""
    for fn in fns[:warmup]:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for fn in fns[warmup:]:
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (len(fns) - warmup)


def kernel_device_ms(calls, launches=30, replays=5):
    """Mean device time of one kernel launch: `calls` (no-argument
    launches of a bare C entry on the current stream, one kernel each)
    are captured in turn into one CUDA graph, whole turns and at least
    `launches` of them, and CUDA events time `replays` replays of it.
    The host's issue rate does not enter this number, as it does CUDA
    events around back-to-back wrapper calls; the gap the graph leaves
    between two kernels does."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    n = len(calls) * -(-launches // len(calls))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(n):
            calls[k % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * n)


def k1_launcher(lib, x, entry):
    """(a no-argument call of lib's bare K1 entry on plane x, launched on
    the stream current at the call, the [4, Ho, Wo] view of its output).
    entry "i32" is pip_halfpel_i32, "u8" pip_halfpel_u8_pitched."""
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch.ops import mc as tmc
    P, I = ctypes.c_void_p, ctypes.c_int
    Hp, Wp = x.shape
    Ho, Wo = Hp - 5, Wp - 5
    if entry == "i32":
        out = torch.empty((4, Ho, Wo), dtype=torch.int32, device=x.device)
        fn = lib.pip_halfpel_i32
        args = [P(x.data_ptr()), P(out.data_ptr()), Hp, Wp]
    else:
        out = torch.empty((4, Ho, tmc._pitch(Wo)), dtype=torch.uint8,
                          device=x.device)
        fn = lib.pip_halfpel_u8_pitched
        args = [P(x.data_ptr()), P(out.data_ptr()), Hp, Wp, out.stride(1)]
    fn.argtypes = [P, P] + [I] * (len(args) - 2) + [P]
    fn.restype = I

    def run(keep=(x, out)):
        _build.check(fn(*args, _build.stream(x.device)), "halfpel")
    return run, out[..., :Wo]


def k1_bytes(Hp, Wp, entry):
    """Bytes K1 must move: the plane read once, four output planes of
    [Hp-5, Wp-5] written once (the pitch's padding is not needed)."""
    return Hp * Wp + 4 * (Hp - 5) * (Wp - 5) * (4 if entry == "i32" else 1)


def k1_calls(lib, x, entry, cold_bytes=100e6, launcher=k1_launcher):
    """Launchers of lib's bare K1 entry (made by `launcher`) over enough
    copies of plane x, each with its own output, that one turn through
    them moves more than `cold_bytes` (twice the H100's 50 MB L2): every
    launch reads and writes buffers the cache no longer holds, as a
    decode's reference plane has left it."""
    Hp, Wp = x.shape
    n = int(min(32, max(2, -(-cold_bytes // k1_bytes(Hp, Wp, entry)))))
    return [launcher(lib, x.clone(), entry)[0] for _ in range(n)]


def k1_conv2d(x):
    """The library yardstick of K1 (chip_smoke only; the port never calls
    it): one float32 F.conv2d of the plane with a [3, 1, 6, 6] weight
    (the tap as row 2 for b, as column 2 for h, their outer product for
    j), then a rounding pass (round, offset, scale, floor, clamp) and the
    G slice, as uint8 [4, Hp-5, Wp-5]. Exact: every sum is an integer
    below 2^24, and main() turns TF32 off for cuDNN."""
    tap = torch.tensor([1., -5., 20., 20., -5., 1.], device=x.device)
    w = torch.zeros((3, 1, 6, 6), device=x.device)
    w[0, 0, 2, :] = tap
    w[1, 0, :, 2] = tap
    w[2, 0] = tap[:, None] * tap[None, :]
    off = torch.tensor([16., 16., 512.], device=x.device)[:, None, None]
    scale = torch.tensor([1 / 32, 1 / 32, 1 / 1024],
                         device=x.device)[:, None, None]
    f = torch.nn.functional.conv2d(x.float()[None, None], w)[0]
    bhj = ((f.round() + off) * scale).floor().clamp(0, 255)
    return torch.cat([x[None, 2:-3, 2:-3], bhj.to(torch.uint8)])


def k2_launcher(lib, mb_w, mb_h, planes, P, dev):
    """A no-argument call of lib's pip_deblock_frame (the bare K2 entry)
    on `planes`, in place, with the packed parameter rows P."""
    from losslessh264_tpu_torch import _build
    Y, U, V = planes
    sync = torch.empty(1 + 2 * mb_h, dtype=torch.int32, device=dev)
    args = [ctypes.c_void_p(a.data_ptr()) for a in (Y, U, V)] + [
        Y.stride(0), U.stride(0), ctypes.c_void_p(P.data_ptr()),
        ctypes.c_void_p(sync.data_ptr()), mb_w, mb_h, _build.stream(dev)]

    def run(keep=(planes, P, sync)):
        _build.check(lib.pip_deblock_frame(*args), "deblock")
    return run


def k2_bytes(mb_w, mb_h):
    """Bytes K2 must move: the picture's pixels of Y, U and V (int32)
    read and written once, and the parameter lanes of each MB's packed
    row read once. Edges on the picture's border are never filtered, so
    the WPAD padding around the planes and the padding lanes of a packed
    row (tdb.PACK_WIDTH is wider than the fields) are not needed."""
    from losslessh264_tpu_torch.ops import deblock as tdb
    pixels = 16 * mb_w * 16 * mb_h * 3 // 2
    lanes = sum(w for _, w in tdb._PACK_FIELDS)
    return 2 * 4 * pixels + 4 * mb_w * mb_h * lanes


def stage_decode(data, device):
    """One decode of the stream with a synchronised timer around every
    stage of TorchDecoder._decode_one (deblock split into _edge_params,
    the K2 wrapper and the crop); returns per-frame rows."""
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch.ops import deblock as tdb
    dec = dt.TorchDecoder(data, device=device)
    rows = []

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    it = iter(dec.sym)
    while True:
        t0 = now()
        try:
            f = next(it)
        except StopIteration:
            return rows
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        dec._prep_refs(mb_w, mb_h)
        planes_np, has_intra = dec._prep_planes(f)
        p = dt.planes_to_torch(planes_np, dec.device)
        t1 = now()
        Yw, Uw, Vw, ry, ru, rv = dt._residual_and_inter(
            mb_w, mb_h, p, dec.ref_y, dec.ref_u, dec.ref_v)
        t2 = now()
        if has_intra:
            Yw, Uw, Vw = dt._intra_scan(mb_w, mb_h, Yw, Uw, Vw, ry, ru, rv,
                                        p, dt.diagonals(mb_w, mb_h))
        t3 = now()
        deblocked = dec._needs_deblock(f, planes_np["nnz"])
        if deblocked:   # decoder_torch._deblock_crop, stage by stage
            params = tdb._edge_params(
                mb_w, mb_h, p["mb_class"], p["qp"], p["nnz"], p["mv"],
                p["ref_idx"], p["slice_id"], p["deblock_idc"],
                p["alpha_off"], p["beta_off"], p["transform8"],
                p["chroma_qp_offset"])
            t3a = now()
            Yw, Uw, Vw = tdb.deblock_wavefront(mb_w, mb_h, Yw, Uw, Vw,
                                               params)
            t3b = now()
        else:
            t3a = t3b = t3
        Y, U, V = dt._crop(mb_w, mb_h, Yw, Uw, Vw)
        t4 = now()
        dec._finish_frame(f, Y, U, V, False)
        t5 = now()
        rows.append(dict(
            frame=len(rows), n_intra=int(sum(
                (f["mb_class"] == c).sum() for c in (0, 1, 2))),
            mc_fast=bool(planes_np["mc_fast"]), deblocked=bool(deblocked),
            host_ms=(t1 - t0) * 1e3, residual_inter_ms=(t2 - t1) * 1e3,
            intra_ms=(t3 - t2) * 1e3, edge_params_ms=(t3a - t3) * 1e3,
            k2_ms=(t3b - t3a) * 1e3, crop_ms=(t4 - t3b) * 1e3,
            store_ms=(t5 - t4) * 1e3))


def profile_windows(data, device, card):
    """torch.profiler over two windows of one decode: P frames 1-3 (the
    steady state of the stream) and frame 10 (3374 of 3600 MBs intra).
    Prints wall time against the summed device time of every kernel and
    copy, and the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    from losslessh264_tpu_torch import decoder_torch as dt
    frames = dt.TorchDecoder(data, device=device).frames()
    done = 0
    for first, last in ((1, 3), (10, 10)):
        while done < first:           # decoded outside the window
            next(frames)
            done += 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while done <= last:
                next(frames)
                done += 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, memcpy): a CPU op's own
        # device total repeats its kernels' time
        evs = [(e.self_device_time_total / 1e3, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e[0] for e in evs)
        log(f"profile frames {first}-{last}: wall {wall_ms:.3f} ms, summed "
            f"device time {busy_ms:.3f} ms, device busy share "
            f"{busy_ms / wall_ms:.4f} on {card}")
        for ms, count, key in sorted(evs, reverse=True)[:6]:
            log(f"  profile {ms:.3f} ms x{count} {key[:90]}")


def main():
    if not os.path.isdir(os.path.join(ROOT, "losslessh264_tpu_torch")):
        sys.exit("chip_smoke.py: losslessh264_tpu_torch/ is not beside "
                 "this script; run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    # The native symbol layer builds itself with make at first use. A CXX
    # inherited from the environment may name a compiler whose
    # LTO plugin the Makefile's -flto link cannot run; build with the
    # compiler the Makefile names itself (g++ on the PATH).
    os.environ["CXX"] = "g++"
    # cuDNN runs float32 convolutions in TF32 unless told not to; the
    # conv2d yardstick of K1 must be exact
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this "
                 "check needs an NVIDIA GPU")
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import native
    from losslessh264_tpu_torch.cases import random_deblock_case
    from losslessh264_tpu_torch.ops import deblock as tdb
    from losslessh264_tpu_torch.ops import mc as tmc

    # ---- 1. device ----
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    report = _build.build()
    _build.lib()
    log(f"build: nvcc sm_90a {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas:", line.strip())

    data = open(STREAM, "rb").read()
    golden = json.load(open(GOLDEN))["synth720p"]["crc32"]

    # ---- 3. K1 against its plain version ----
    rng = np.random.default_rng(0)
    dec0 = dt.TorchDecoder(data, device=dev)
    Y0 = next(dec0.frames())[0]

    def rand_plane(Hp, Wp):
        return torch.as_tensor(rng.integers(0, 256, (Hp, Wp), dtype=np.uint8),
                               device=dev)
    misaligned = torch.empty(784 * 1344 + 1, dtype=torch.uint8,
                             device=dev)[1:].view(784, 1344)
    misaligned.copy_(rand_plane(784, 1344))
    k1_inputs = [
        ("random 784x1344", rand_plane(784, 1344)),
        ("synth720p frame 0 padded", dt._edge_pad(Y0, dt.PAD)),
        ("random 1152x1984 (1080p)", rand_plane(1152, 1984)),
        ("random 2224x3904 (2160p)", rand_plane(2224, 3904)),
        ("misaligned pointer 784x1344 (byte loads)", misaligned),
        # one 128-column strip exactly, and one column more or less
        ("Wp 133 (byte loads)", rand_plane(133, 133)),
        ("Wp 134 (byte loads)", rand_plane(70, 134)),
        ("Wp 132 (byte loads)", rand_plane(300, 132)),
        ("Wp 400, Wo 395 ragged", rand_plane(262, 400)),
        ("odd 781x1351", rand_plane(781, 1351)),
        ("odd 42x58", rand_plane(37 + 5, 53 + 5)),
        ("odd 6x6", rand_plane(6, 6)),
        ("odd 101x77", rand_plane(101, 77)),
    ]
    k1_err = 0
    for name, x in k1_inputs:
        want = tmc.halfpel_planes_plain(x)
        got = tmc.halfpel_planes(x)
        got8 = tmc._halfpel_planes_u8(x)
        torch.cuda.synchronize()
        k1_err = max(k1_err, max_abs_err(got, want),
                     max_abs_err(got8, want))
        if not (torch.equal(got, want)
                and torch.equal(got8, want.to(torch.uint8))):
            raise SystemExit(f"K1 halfpel mismatch on {name}: max abs err "
                             f"{k1_err}")
        if got8.stride(1) != tmc._pitch(x.shape[1] - 5):
            raise SystemExit(f"K1 uint8 entry on {name}: row stride "
                             f"{got8.stride(1)}, not the 16-byte pitch")
        log(f"K1 halfpel == plain: {name} {tuple(x.shape)}")
    for name, x in k1_inputs[1:4]:
        if not torch.equal(k1_conv2d(x),
                           tmc.halfpel_planes_plain(x).to(torch.uint8)):
            raise SystemExit(f"K1 conv2d yardstick differs from the plain "
                             f"version on {name}")
    log("K1 conv2d yardstick == plain at 720p, 1080p and 2160p")

    # ---- 4. K2 against its plain version, 20 launches per case ----
    k2_err = 0
    cases = [(w, h, seed) for w, h in ((9, 4), (12, 7), (22, 18), (45, 30),
                                       (80, 45)) for seed in (0, 1)]
    cases += [(120, 68, 2), (4, 150, 3), (1, 9, 4), (2, 7, 5)]
    for mb_w, mb_h, seed in cases:
        (Yw, Uw, Vw), _, params = random_deblock_case(mb_w, mb_h, seed,
                                                      dev)
        want = tdb.deblock_wavefront_plain(mb_w, mb_h, Yw, Uw, Vw, params)
        for rep in range(20):
            got = tdb.deblock_wavefront(mb_w, mb_h, Yw, Uw, Vw, params)
            torch.cuda.synchronize()
            for g, w, pl in zip(got, want, "YUV"):
                k2_err = max(k2_err, max_abs_err(g, w))
                if not torch.equal(g, w):
                    raise SystemExit(f"K2 deblock mismatch {mb_w}x{mb_h} "
                                     f"seed {seed} launch {rep} plane {pl}")
        log(f"K2 deblock == plain: {mb_w}x{mb_h} MBs seed {seed}, "
            f"20 launches")

    # ---- 5. decode the stream on the card ----
    deblocked = sum(bool(dt.TorchDecoder._needs_deblock(
        f, dt.TorchDecoder._nnz_plane(f))) for f in native.SymbolDecoder(data))
    tmc.halfpel_planes.launches = 0
    tdb.deblock_wavefront.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = dt.TorchDecoder(data, device=dev)
    frames = [tuple(a.cpu() for a in yuv) for yuv in dec.frames()]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    k1_launches = tmc.halfpel_planes.launches
    k2_launches = tdb.deblock_wavefront.launches
    if len(frames) != len(golden):
        raise SystemExit(f"decoded {len(frames)} frames, expected "
                         f"{len(golden)}")
    for i, (Y, U, V) in enumerate(frames):
        if tuple(Y.shape) != (720, 1280) or tuple(U.shape) != (360, 640):
            raise SystemExit(f"frame {i}: shapes {Y.shape} {U.shape}")
        crc = zlib.crc32(Y.numpy().tobytes() + U.numpy().tobytes()
                         + V.numpy().tobytes())
        if crc != golden[i]:
            raise SystemExit(f"frame {i}: CRC {crc} != NpDecoder golden "
                             f"{golden[i]}")
    log(f"decode: {len(frames)} frames of synth720p match the NpDecoder "
        f"CRCs; {decode_s:.3f} s = {len(frames) / decode_s:.3f} fps "
        f"(incl. host symbol decode) on {card}")
    log(f"launches during decode: K1 halfpel {k1_launches}, "
        f"K2 deblock {k2_launches} for {deblocked} deblocked frames")
    if k1_launches <= 0 or k2_launches <= 0:
        raise SystemExit("a kernel of the decode path was never launched")
    if k2_launches != deblocked:
        raise SystemExit(f"K2 launched {k2_launches} times for {deblocked} "
                         "deblocked frames; one launch per frame expected")

    # ---- 6. times ----
    # K1 at each size, both entries: `ms` the wrapper by CUDA events over
    # back-to-back calls, `kernel_ms` the bare C entry's kernel alone (a
    # CUDA graph's replays, cold L2), beside the bound, the plain version
    # and the conv2d yardstick. 720p is the decode path's reference plane
    # (frame 0 of synth720p, padded), the others random planes.
    k1_sizes = {}
    k1_planes = dict(zip(K1_SIZES, (k1_inputs[1][1], k1_inputs[2][1],
                                    k1_inputs[3][1])))
    for size, x in k1_planes.items():
        Hp, Wp = x.shape
        if (Hp, Wp) != K1_SIZES[size]:
            raise SystemExit(f"K1 {size} input is {Hp}x{Wp}")
        ops = K1_OPS_PER_POSITION * (Hp - 5) * (Wp - 5)
        row = {}
        for entry, wrapper in (("i32", tmc.halfpel_planes),
                               ("u8", tmc._halfpel_planes_u8)):
            n_bytes = k1_bytes(Hp, Wp, entry)
            row[f"ms_{entry}"] = cuda_ms(lambda: wrapper(x), 50)
            row[f"kernel_ms_{entry}"] = kernel_device_ms(
                k1_calls(_build.lib(), x, entry))
            row[f"bytes_{entry}"] = n_bytes
            row[f"bound_ms_{entry}"], row[f"bound_by_{entry}"] = bound_ms(
                n_bytes, ops)
            row[f"bound_share_{entry}"] = row[f"bound_ms_{entry}"] / \
                row[f"kernel_ms_{entry}"]
        row["plain_ms"] = cuda_ms(lambda: tmc.halfpel_planes_plain(x), 5,
                                  warmup=1)
        row["library_ms"] = cuda_ms(lambda: k1_conv2d(x), 20)
        k1_sizes[size] = row
        log(f"time K1 halfpel {size} {Hp}x{Wp}: "
            + "; ".join(
                f"{e} entry kernel {row[f'kernel_ms_{e}']:.5f} ms, wrapper "
                f"{row[f'ms_{e}']:.4f} ms, bound {row[f'bound_ms_{e}']:.5f} "
                f"ms by {row[f'bound_by_{e}']} ({row[f'bytes_{e}']} bytes),"
                f" share {row[f'bound_share_{e}']:.3f}" for e in ("i32", "u8"))
            + f"; plain torch {row['plain_ms']:.4f} ms, conv2d + rounding "
            f"pass {row['library_ms']:.4f} ms on {card}")
    # K2 at 80x45 MBs on the parity inputs of 80x45 seed 0: `ms` is the
    # wrapper (packing, int32 copies of the planes, the launch);
    # `kernel_ms` the bare C entry on packed rows, each timed launch on
    # its own fresh copy of the planes
    (Yw, Uw, Vw), _, params = random_deblock_case(80, 45, 0, dev)
    k2_ms = cuda_ms(lambda: tdb.deblock_wavefront(
        80, 45, Yw, Uw, Vw, params), 20)
    P = tdb._pack_params(params).contiguous()
    k2_kernel_ms = cuda_ms_each([
        k2_launcher(_build.lib(), 80, 45, [a.clone() for a in (Yw, Uw, Vw)],
                    P, dev) for _ in range(22)])
    k2_plain_ms = cuda_ms(lambda: tdb.deblock_wavefront_plain(
        80, 45, Yw, Uw, Vw, params), 3, warmup=1)
    # ~40 int32 ops per luma line of an edge (16 lines x 8 edges per MB)
    # and ~20 per chroma line (8 lines x 4 edges x 2 planes)
    k2_b = k2_bytes(80, 45)
    k2_bound, k2_by = bound_ms(k2_b, 80 * 45 * (128 * 40 + 64 * 20))
    log(f"time K2 deblock 80x45 MBs per frame: wrapper (packing, copies, "
        f"kernel) {k2_ms:.4f} ms, kernel alone {k2_kernel_ms:.4f} ms = "
        f"{k2_kernel_ms * 1e3 / (2 * 44 + 80):.3f} us per step of the "
        f"{2 * 44 + 80}-MB chain; bound {k2_bound:.4f} ms by {k2_by} "
        f"({k2_b} bytes); plain torch {k2_plain_ms:.4f} ms on {card}")
    rows = stage_decode(data, dev)
    for r in rows:
        log("stage " + json.dumps({k: (round(v, 3) if isinstance(v, float)
                                       else v) for k, v in r.items()}))
    for key in ("host_ms", "residual_inter_ms", "intra_ms", "edge_params_ms",
                "k2_ms", "crop_ms", "store_ms"):
        log(f"stage total {key}: {sum(r[key] for r in rows):.3f} ms over "
            f"{len(rows)} frames on {card}")
    k1 = k1_sizes["720p"]
    profile_windows(data, dev, card)

    log(json.dumps({"kernels": [
        {"name": "halfpel_planes", "route": "cuda",
         "source": "losslessh264_tpu_torch/csrc/halfpel.cu",
         "replaces": "losslessh264_tpu/ops/mc.py:144",
         "launches": k1_launches, "launches_per_decode": k1_launches,
         "max_abs_err": k1_err, "ms": k1["ms_i32"],
         "ms_uint8_entry": k1["ms_u8"], "kernel_ms": k1["kernel_ms_i32"],
         "kernel_ms_uint8_entry": k1["kernel_ms_u8"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms_i32"],
         "bound_by": k1["bound_by_i32"],
         "bound_ms_uint8_entry": k1["bound_ms_u8"],
         "library_ms": k1["library_ms"], "sizes": k1_sizes},
        {"name": "deblock_wavefront", "route": "cuda",
         "source": "losslessh264_tpu_torch/csrc/deblock.cu",
         "replaces": "losslessh264_tpu/ops/deblock_pallas.py:199",
         "launches": k2_launches, "launches_per_decode": k2_launches,
         "max_abs_err": k2_err, "ms": k2_ms, "kernel_ms": k2_kernel_ms,
         "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
