#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU (run from the repo root).

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):
  1. device: the card's name and power limit (nvidia-smi), torch's name.
  2. build: nvcc compiles losslessh264_tpu_torch/csrc/*.cu for sm_90a.
  3. K1 (csrc/halfpel.cu) against its plain torch version on the card:
     edge-padded 720p planes (784x1344, random and frame 0 of
     tests/data/synth720p.264) and odd sizes. Exact (torch.equal).
  4. K2 (csrc/deblock.cu) against its plain version on the card: random
     planes and symbol planes on 9x4 .. 80x45 MBs x 2 seeds. Exact.
  5. decode: all 25 frames of synth720p with TorchDecoder(device="cuda");
     every frame's CRC32 of Y|U|V must equal the committed NpDecoder
     goldens (tests/data/synth720p_np_crc.json), and both kernels'
     launch counters must rise during the decode.
  6. times: K1 and K2 against their plain versions at 720p (CUDA
     events), a per-stage breakdown of every frame, and torch.profiler
     windows (P frames 1-3, intra frame 10) with the device busy share.

The line before the last is the kernel report
{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms"}, ...]}, preceded by the card line; the
last line is {"ok": true, "device": {"platform": "gpu", ...}}. Without a
GPU, or without the package beside it, the script exits non-zero and
prints no result.
"""
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


def random_deblock_case(mb_w, mb_h, seed, device):
    """Random WPAD-padded planes and symbol planes (the recipe of
    tests/test_deblock_impls.py), as _edge_params inputs on `device`."""
    from losslessh264_tpu_torch.ops import deblock as tdb
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    P = tdb.WPAD
    planes = [rng.randint(0, 256, s).astype(np.int32) for s in
              ((H + 2 * P, W + 2 * P), (H // 2 + 2 * P, W // 2 + 2 * P),
               (H // 2 + 2 * P, W // 2 + 2 * P))]
    sym = dict(
        cls=rng.randint(0, 9, (n,)), qp=rng.randint(10, 52, (n,)),
        nnz=rng.randint(0, 3, (n, 16)), mv=rng.randint(-16, 17, (n, 16, 2)),
        ref_idx=rng.randint(0, 2, (n, 16)),
        slice_id=np.arange(n) // (mb_w * 2), deblock_idc=np.zeros(n),
        alpha_off=np.zeros(n), beta_off=np.zeros(n),
        transform8=rng.randint(0, 2, (n,)))
    t = {k: torch.as_tensor(np.asarray(v, np.int32), device=device)
         for k, v in sym.items()}
    params = tdb._edge_params(
        mb_w, mb_h, t["cls"], t["qp"], t["nnz"], t["mv"], t["ref_idx"],
        t["slice_id"], t["deblock_idc"], t["alpha_off"], t["beta_off"],
        t["transform8"], 0)
    return [torch.as_tensor(a, device=device) for a in planes], params


def stage_decode(data, device):
    """One decode of the stream with a synchronised timer around every
    stage of TorchDecoder._decode_one; returns per-frame rows."""
    from losslessh264_tpu_torch import decoder_torch as dt
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
        if dec._needs_deblock(f, planes_np["nnz"]):
            Y, U, V = dt._deblock_crop(mb_w, mb_h, Yw, Uw, Vw, p)
        else:
            Y, U, V = dt._crop(mb_w, mb_h, Yw, Uw, Vw)
        t4 = now()
        dec._finish_frame(f, Y, U, V, False)
        t5 = now()
        rows.append(dict(
            frame=len(rows), n_intra=int(sum(
                (f["mb_class"] == c).sum() for c in (0, 1, 2))),
            mc_fast=bool(planes_np["mc_fast"]),
            host_ms=(t1 - t0) * 1e3, residual_inter_ms=(t2 - t1) * 1e3,
            intra_ms=(t3 - t2) * 1e3, deblock_ms=(t4 - t3) * 1e3,
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
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this "
                 "check needs an NVIDIA GPU")
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch import decoder_torch as dt
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
    k1_inputs = [
        ("random 784x1344", torch.as_tensor(
            rng.integers(0, 256, (784, 1344), dtype=np.uint8), device=dev)),
        ("synth720p frame 0 padded", dt._edge_pad(Y0, dt.PAD)),
        ("odd 42x58", torch.as_tensor(
            rng.integers(0, 256, (37 + 5, 53 + 5), dtype=np.uint8),
            device=dev)),
        ("odd 6x6", torch.as_tensor(
            rng.integers(0, 256, (6, 6), dtype=np.uint8), device=dev)),
        ("odd 101x77", torch.as_tensor(
            rng.integers(0, 256, (101, 77), dtype=np.uint8), device=dev)),
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
        log(f"K1 halfpel == plain: {name} {tuple(x.shape)}")

    # ---- 4. K2 against its plain version ----
    k2_err = 0
    for mb_w, mb_h in ((9, 4), (12, 7), (22, 18), (45, 30), (80, 45)):
        for seed in (0, 1):
            (Yw, Uw, Vw), params = random_deblock_case(mb_w, mb_h, seed, dev)
            want = tdb.deblock_wavefront_plain(mb_w, mb_h, Yw, Uw, Vw,
                                               params)
            got = tdb.deblock_wavefront(mb_w, mb_h, Yw, Uw, Vw, params)
            torch.cuda.synchronize()
            for g, w, pl in zip(got, want, "YUV"):
                k2_err = max(k2_err, max_abs_err(g, w))
                if not torch.equal(g, w):
                    raise SystemExit(f"K2 deblock mismatch {mb_w}x{mb_h} "
                                     f"seed {seed} plane {pl}")
            log(f"K2 deblock == plain: {mb_w}x{mb_h} MBs seed {seed}")

    # ---- 5. decode the stream on the card ----
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
        f"K2 deblock {k2_launches}")
    if k1_launches <= 0 or k2_launches <= 0:
        raise SystemExit("a kernel of the decode path was never launched")

    # ---- 6. times ----
    x = k1_inputs[1][1]
    k1_ms = cuda_ms(lambda: tmc.halfpel_planes(x), 50)
    k1u8_ms = cuda_ms(lambda: tmc._halfpel_planes_u8(x), 50)
    k1_plain_ms = cuda_ms(lambda: tmc.halfpel_planes_plain(x), 50)
    log(f"time K1 halfpel 784x1344 -> int32: kernel {k1_ms:.4f} ms, "
        f"uint8 entry {k1u8_ms:.4f} ms, plain torch {k1_plain_ms:.4f} ms "
        f"on {card}")
    (Yw, Uw, Vw), params = random_deblock_case(80, 45, 0, dev)
    k2_ms = cuda_ms(lambda: tdb.deblock_wavefront(80, 45, Yw, Uw, Vw,
                                                  params), 10)
    k2_plain_ms = cuda_ms(lambda: tdb.deblock_wavefront_plain(
        80, 45, Yw, Uw, Vw, params), 3, warmup=1)
    log(f"time K2 deblock 80x45 MBs per frame: kernel {k2_ms:.4f} ms, "
        f"plain torch {k2_plain_ms:.4f} ms on {card}")
    rows = stage_decode(data, dev)
    for r in rows:
        log("stage " + json.dumps({k: (round(v, 3) if isinstance(v, float)
                                       else v) for k, v in r.items()}))
    for key in ("host_ms", "residual_inter_ms", "intra_ms", "deblock_ms",
                "store_ms"):
        log(f"stage total {key}: {sum(r[key] for r in rows):.3f} ms over "
            f"{len(rows)} frames on {card}")
    profile_windows(data, dev, card)

    log(json.dumps({"kernels": [
        {"name": "halfpel_planes", "route": "cuda",
         "source": "losslessh264_tpu_torch/csrc/halfpel.cu",
         "replaces": "losslessh264_tpu/ops/mc.py:144",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "deblock_wavefront", "route": "cuda",
         "source": "losslessh264_tpu_torch/csrc/deblock.cu",
         "replaces": "losslessh264_tpu/ops/deblock_pallas.py:199",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
