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
     goldens (tests/data/synth720p_np_crc.json), K9 and K2 must launch
     exactly once per frame that is deblocked, K3 once per frame with intra
     MBs (frames 0, 10 and 20), K6 once per P frame on the bucketed MC
     path and K1 once per slot such a frame reads, K11 once per P frame on
     the per-cell MC route (a second decode, under a sync=True recording
     of the port's tracer, counts the MC routes its plans took), K7 once
     per frame, K4, K5 and K8 never.
  6. encode: TorchEncoder(device="cuda") at 1280x720 on the first frames
     of phase 5's decode, in the configurations of
     tests/data/synth720p_enc_golden.json and its sibling
     synth720p_enc_golden_cde.json (written with the JAX package on the
     CPU by tools/gen_enc_golden.py): A (qp=28, gop=0: an IDR and 3 P
     frames), B (qp=28, refs=2, cabac=True: an IDR and 2 P frames, K1 on
     the 784x2688 concatenated reference, the CABAC writer), C (a 2 Mbps
     RateControl, AQ, GOM RC, background detection, scroll ME, denoise
     and LTR, mark_ltr before frame 2 and recover_from_ltr before frame
     3: the per-MB QP path, 4 frames), D (temporal_layers=4 with
     1400-byte slices: an IDR, then T3 T2 T3 T1, the last with RPLR and
     an MMCO drop) and E (SimulcastEncoder, 2 spatial layers with
     inter-layer prediction, 2 access units). Every frame's SHA-256 and
     recon CRC32 (E: per layer) must equal the golden. The port's decoder
     on the card must give back the encoder's recon after every reference
     frame and, for C, D and E, the JAX decoders' pictures of the golden
     (TorchDecoder; E: the port's SimulcastDecoder). K1 must launch once
     per P encode, K2 and K9 once per encode that deblocks, K4 once per
     encode with intra MBs, K5 once per reference a P encode searches (B's
     second P frame two) and K8 once per P encode, as JaxEncoder's
     control flow implies (no K2 for a fused-path non-reference P frame
     without intra MBs; a size-capped slice's re-encode counts again),
     K3, K6, K7 and K11 never.
     A first pass gives encode fps, a second the per-stage wall times of
     every frame (encoder_torch.StageTimer).
  7. older encoder: losslessh264_tpu_torch.encoder.Encoder(1280, 720,
     qp=26) on frames 0-2 of phase 5's decode (an I16x16 IDR, 2 P frames
     with the integer-pel window search on the card), against
     configuration F of tests/data/synth720p_enc_golden_f.json (SHA-256
     and reference CRC32 per frame); TorchDecoder on the card must give
     back the encoder's reference and NpDecoder's picture of every frame;
     no kernel may launch (no loop filter, integer-pel, host intra). Prints
     fps and the split between the device search and the host loops.
  8. GOP-parallel decode: synth720p.264 written twice in a row (2 GOPs,
     50 frames) through parallel.decode_yuv_gop_parallel with 2 workers
     (a TorchDecoder and a CUDA stream each), then through one sequential
     TorchDecoder; every frame's CRC32 must equal the golden,
     twice over, and each decode must launch K1-K9 and K11 twice as
     often as phase 5's decode. Prints both fps.
  9. CLI: `python -m losslessh264_tpu_torch walk_analog.264 x.pip
     --shards 4` (must equal native.compress_sharded and decompress to
     the input) and `roundtrip ... --shards 4` (must print bit-exact), as
     subprocesses on the port's binding of the native layer.
 10. graft: graft_entry.dryrun_multichip(2) on the card, two gloo ranks
     at 80x45 MBs; each rank's recY, mvx and bits must equal the step in
     this process, the all-reduced total their sum, and each rank must
     launch K1, K2, K5, K8 and K9 once (K3, K4, K6, K7 and K11 never, in
     this process's runs).
 11. runs decode: tests/data/runs720p.264 (tools/gen_run_streams.py)
     with TorchDecoder on the card: four IDRs as one all-intra batch
     (recon_intra_batch), then P frames whose intra MBs populate 0, 1, 8
     and 42 of the 168 diagonals (no intra pass, the sparse pass over the
     populated ones, the full table). Every frame's CRC32 must equal
     NpDecoder's (tests/data/runs720p_np_crc.json), each frame must take
     its route, K2 and K9 must launch once per deblocked frame, K1, K6
     and K11 as the MC plans imply, K3 once per route with an intra pass
     (the batch of 4 once: 4 in all) and K7 once per frame. A recorded
     decode (the tracer, sync=True) prints each frame's intra ms on its
     route (K3) beside the plain full-table pass on the same planes, which
     a third decode runs on every intra pass's inputs (and requires the
     two equal).
 12. encode runs: configuration G (tests/data/synth720p_enc_golden_g.json,
     A's settings on frames 0-6) through TorchEncoder.encode_frames(batch=
     3): an IDR and two runs of 3 P frames, each run's entropy written on
     a writer thread while the next run's device work goes on. SHA-256 of
     every frame, the recon after the runs, frames 0-3 also against
     golden A, K1 / K2 / K4 / K5 / K8 / K9 as the encodes imply; then the 6 P
     frames in turns one encode_frame each and in runs, from the IDR's state, each turn
     held to the golden: P-frame fps of both, the writer's ms and the ms
     the caller waited for it.
 13. K3 and K4 against their plain versions on the card, exact: K3 on
     random cases (cases.random_intra_case: every class and mode, I8x8,
     slices starting mid-row; 9x4 .. 80x45 MBs, 1 or 4 frames, a column
     and a row of MBs; 5 launches each) and on synth720p's intra frames
     0, 10 and 20; K4 on random cases (random_intra_encode_case, qp 0 ..
     51 and per-MB planes; 3 launches each), A's IDR and C's per-MB-QP
     IDR (phase 5's frame 0 at C's IDR qp plane); and the cases of the
     multi-warp designs: a 720p frame of I4x4 MBs only (K3), 720p all intra
     at qp 0 and 51 and striped intra/inter MBs (K4), and 720p's MB row
     (80x1) and MB column (1x45). Their times at 720p (K3: synth720p frame
     0's full pass; K4: A's IDR): wrapper, kernel alone, plain version,
     bound and chain length; and each kernel alone on the 80x1 row (the MB's
     own compute) and the 1x45 column (compute and hand-off), per MB.
 14. K5 and K6 against their plain versions on the card, exact: K5 on
     cases.K5_CASES (720p radius 16 on noise, flat and periodic planes,
     64x48 at radius 4-6, 1080p, 40x23 and 30x7 MBs, widths of 5, 9 and
     13 MBs, radius 0, 1, 3, 8 and 22, scrolled and strided reference
     windows, the best dy at either end of the search; 3 launches each)
     and synth720p frame 1 against frame 0, refusing radius 23; K6 on
     cases.K6_CASES (1, 2 and 32 table triples, 1 and 2 slots, 0 and 512
     fix-up cells, MVs at +-MC_MV_MAX, far MBs whose clipped and long MVs
     make fix-up cells on every ring slot; 3 launches each) and every
     bucketed P frame of
     synth720p and runs720p (logging each frame's fix-up cells), refusing
     a window off the planes. Their times: K5 at 720p radius 16 on the
     synth720p pair, K6 per bucketed P frame of synth720p: wrapper, kernel
     alone, plain version, bound. Beside them K11 (cells_phase) on
     cases.K11_CASES (every MV phase, clipped MVs, every ring slot, WP with
     a partial chroma mask; 3 launches each; the JAX package's CRCs of
     tests/data/k11_jax_crc.json) and every per-cell P frame of runs720p
     and of the walk stand-in's frames 0-23 and 200-299, each GOP decoded
     alone; its time per per-cell P frame of the walk stand-in's frames
     0-23: wrapper, kernel alone, the torch chain it replaces (its plain
     version), bound.
 15. K7 and K8 against their plain versions on the card, exact: K7 on
     cases.K7_CASES (every class, cbp and MC route, PCM, 8x8 transforms,
     scaling matrices, qp 0 and 51, chroma QP offsets of +-12, levels at
     the int16 extremes, transform8 on every non-I16 MB of a 720p frame,
     widths of 11 and 13 MBs; 4x3 to 720p; 3 launches each) and on every frame
     of a decode of synth720p and of runs720p (each call of the decode
     held to the plain version on its arguments, cases.HeldToPlain; the
     CRCs must hold); K8 on cases.K8_CASES (per-MB qp with 0 and 51, R 1
     and 2, rd_lam None and 144, chroma windows clamped on every side,
     uint8 and int32 sources, 7x3 and 13x2 MBs; 3 launches each) and on
     every P frame of
     the encodes of A-E and G (held the same way; the SHA-256 must hold).
     K9 is held the same way on every call of those decodes and encodes
     (phase 16). Their times: K7 per frame of synth720p (means over the P
     frames, those with a prediction, and over the IDR), K8 per P frame of A:
     wrapper, kernel alone (a CUDA graph's replays over copies of the
     operands that move more than 100 MB a turn: cold L2), plain
     version, bound.
 16. K9 against its plain version on the card, exact in all 384 lanes:
     on cases.K9_CASES (the decoder's dtypes, int32, the encoder's planes
     with absent offsets and an expanded ref_idx, PCM, qp 0 and 51 with
     offsets of +-12, chroma QP offsets of +-12, deblock_idc 1 and 2 with
     slices that start mid-row; 1x1 to 720p; 3 launches each); phase 15
     held it (cases.HeldToPlain) on every call of its decodes of synth720p
     and runs720p and its encodes of A-E and G, where it must launch just
     where K2 does. Its times per deblocked frame of synth720p and of
     encode A: wrapper, kernel alone (cold L2, a CUDA graph's replays),
     plain version, bound.
 17. times: K1 at 720p, 1080p, 2160p and on the encoder's refs=2 plane
     (784x2688), both entries, wrapper and kernel alone, beside their
     bounds, its plain version and the conv2d yardstick; K2 against its
     plain version at 720p (CUDA events; the wrapper on packed rows); the
     per-stage breakdown of every
     decoded frame from phase 5's recorded decode (DECODE_STAGE_SPANS:
     the inter prediction, mc_ms, the residual reconstruction,
     residual_recon_ms: K7's wrapper; deblock split into edge parameters,
     edge_params_ms: K9's wrapper, K2 and crop);
     then torch.profiler windows (decode: P frames 1-3, intra frame 10;
     encode A: P frames 1-3) with the device busy share. A profiler
     session slows the host's launches after it, so the windows come
     last.

The line before the last is the kernel report
{"kernels": [{"name", "route", "source", "replaces", "launches",
"launches_per_decode", "launches_per_encode", "max_abs_err", "ms",
"plain_ms", "bound_ms", "bound_by", "library_ms"}, ...]} for K1-K9 and
K11, preceded by the card line; `launches` counts phases 5-12 (the main
paths' own runs, each path's counts set to 0 just before it), and
`launches_per_decode`,
`_per_encode`, `_per_older_encode`, `_per_gop_parallel_decode`,
`_per_graft_ranks`, `_per_runs_decode` and `_per_encode_runs` each path's
own count (K1 and K2 print `launches_per_decode` and `_per_encode` and
the other paths; K3-K9 and K11 every path, `launches_per_decode`
included). For
K1:
`ms`, `kernel_ms`, `bound_ms` and `bound_by` are its int32 entry's at
720p, and `ms_uint8_entry`, `kernel_ms_uint8_entry` and
`bound_ms_uint8_entry` those of the uint8 entry that the decode and
encode paths call. `ms` is the wrapper, timed by CUDA events around 50
back-to-back calls (the host's issue rate enters it); `kernel_ms` is the
kernel alone: CUDA events around the replays of a CUDA graph of at least
30 captured launches of the bare C entry, each on buffers that are no
longer in L2 (kernel_device_ms, k1_calls), so it holds the graph's gap
between two kernels but not the host. `library_ms` is the conv2d
yardstick at 720p (k1_conv2d: F.conv2d in float32 with TF32 off, then a
rounding pass). `sizes` holds, for "720p", "1080p", "2160p" and
"720p_refs2" (the encoder's two references side by side), `ms_i32`,
`ms_u8`, `kernel_ms_i32`, `kernel_ms_u8`, `bytes_*`, `bound_ms_*`,
`bound_by_*`, `bound_share_*` (bound over kernel time), `plain_ms` and
`library_ms`. K2's `ms` is its wrapper on packed rows (plane copies, launch)
and `kernel_ms` the bare C entry by CUDA events, each launch on fresh
planes. K3's and K4's `ms` is the wrapper, `kernel_ms` the bare C entry
(CUDA events, each launch on its own copy of the planes), `chain_steps`
the wavefront's dependent MB steps, `row_80x1_ms` / `column_1x45_ms`
the kernel alone on one 720p MB row (the MB's own compute, no wait) and
one MB column (compute and hand-off at every MB), with their
`_us_per_mb`, `library_ms` null (no PyTorch call computes them); K3's
`replaces_also` names the two other JAX scans it serves. K5's `ms` is
the wrapper at 720p radius 16, `kernel_ms` the bare C entry (a CUDA
graph's replays), with its `operations`, `bytes` and `bound_share`; K6's
are the means over synth720p's bucketed P frames (`frames` of them; its
wrapper's `ms` holds the K1 launches before the kernel), with their
`fix_cells`. K6's `operands_ms` is its wrapper but for the launch: K1,
the window checks and the outputs (`ops/mc.k6_operands`); `k1_ms` the
K1 calls of the frame's active slots in it. K5's `int32_rate_ms` is its
operations at the int32 lane rate. K7's `ms`, `kernel_ms`, `plain_ms`
and bound are the means over synth720p's P frames (`frames` of them, the
frames with a prediction; `intra_frames` the same over its IDR,
`per_frame` each frame's), K8's over A's P frames 1-3, K9's over the
deblocked frames of synth720p (`encode_a`: the same over encode A's
frames). `library_ms` is null for K2-K9 (no PyTorch call computes them).
The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
Without a GPU, or without the package beside it, the script exits
non-zero and prints no result.

Bounds: the larger of the bytes each kernel must move (every input read
once, every output written once) over 3.35 TB/s, and its integer
operations over 33.5 TOP/s (the H100 SXM's 67 TFLOP/s float32 rate
outside the tensor cores, halved: an SM has half as many int32 lanes as
float32 lanes). K5's operations are on 8-bit samples, and the kernel runs
them 4 to a 32-bit instruction, so the int32 rate is no bound for it:
its operations count at the card's 8-bit peak, 1979 TOP/s (int8, tensor
cores). Tensor cores cannot take an absolute difference: K5's bound at
the measured rate of the fastest byte SAD (vabsdiff4 with its
accumulate) is tools/sad_rates.py's, not this script's. K6's bytes are
the input samples its frame's prediction depends on, each once
(k6_reads). K1, K2, K3, K6, K7, K8 and K9 are bound by bytes,
K4 and K5 by operations (K3_OPS_PER_MB, K4_OPS_PER_MB, k5_bytes_ops:
3 per pixel and displacement); K2, K3 and K4 are far from the bound, a
chain of dependent MB steps. K7's and K8's bytes are the inputs the
frame's outputs depend on, each once, and the outputs (k7_bytes_ops,
k8_bytes_ops); K9's its planes' distinct elements in their own dtypes,
the tables and its [n, 384] rows (k9_bytes_ops).
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
ENC_GOLDEN = os.path.join(ROOT, "tests", "data", "synth720p_enc_golden.json")
ENC_GOLDEN_CDE = os.path.join(ROOT, "tests", "data",
                              "synth720p_enc_golden_cde.json")
ENC_GOLDEN_F = os.path.join(ROOT, "tests", "data",
                            "synth720p_enc_golden_f.json")
ENC_GOLDEN_G = os.path.join(ROOT, "tests", "data",
                            "synth720p_enc_golden_g.json")
RUNS_STREAM = os.path.join(ROOT, "tests", "data", "runs720p.264")
WALK_STREAM = os.path.join(ROOT, "bench_port", "data",
                           "walk_analog_1331.264")
RUNS_GOLDEN = os.path.join(ROOT, "tests", "data", "runs720p_np_crc.json")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12     # see the module docstring
INT8_OPS_PER_S = 1979e12      # H100 SXM int8 peak (tensor cores, dense)
# K1's timed sizes: the edge-padded (PAD = 32) luma reference of 720p,
# 1080p (1088 coded rows) and 2160p, and the encoder's two 720p
# references side by side (refs=2)
K1_SIZES = {"720p": (784, 1344), "1080p": (1152, 1984),
            "2160p": (2224, 3904), "720p_refs2": (784, 2688)}
# the encoder's per-frame stages (encoder_torch.StageTimer), in order
ENC_STAGES = ("upload", "dense_search", "subpel_k1", "residual", "fetch",
              "intra", "deblock_host_planes", "deblock_upload",
              "deblock_edge_params", "deblock_k2", "write",
              "denoise", "scene_cut", "rc", "scroll", "aq_maps",
              "dyn_slice_reencode")
# 3 six-taps (b, h, j) of 11 ops, 3 round-and-clamps of 4 ops and the j
# pass over the b sums: ~50 int32 ops per output position
K1_OPS_PER_POSITION = 50


def log(*a):
    print(*a, flush=True)


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K11")


def wrappers():
    """The wrappers whose `launches` count K1-K9 and K11, in KERNELS
    order."""
    from losslessh264_tpu_torch import trace
    return trace.launch_wrappers()


def reset_launches():
    for w in wrappers():
        w.launches = 0


def launches_now():
    """(K1, ..., K9, K11) launches since the last reset_launches()."""
    return tuple(w.launches for w in wrappers())


def launch_str(counts):
    return ", ".join(f"{k} {v}" for k, v in zip(KERNELS, counts))


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


def bound_ms(n_bytes, n_ops, ops_per_s=INT32_OPS_PER_S):
    """(the least time the card could take, what bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same(got, want, what):
    """The largest difference of a kernel's outputs `got` from its plain
    version's `want` (0); exits if a dtype or a value differs (phases 14
    and 15)."""
    torch.cuda.synchronize()
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    if err or not all(g.dtype == w.dtype and torch.equal(g, w)
                      for g, w in zip(got, want)):
        raise SystemExit(f"{what}: the kernel differs from its plain "
                         f"version (max abs err {err})")
    return err


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


# a decoded frame's stage columns and the tracer's spans that fill them
# (their self times in a sync=True recording, per frame; the symbol
# parse-ahead worker's spans belong to no frame, so the symbol layer is
# the main thread's wait for a frame)
DECODE_STAGE_SPANS = {
    "host_ms": ("dec.symbols", "dec.symbols.wait", "dec.frame", "dec.plan",
                "dec.plan.refs", "dec.plan.slots", "dec.plan.intra",
                "dec.plan.avail", "dec.plan.nnz", "dec.plan.mc",
                "dec.plan.scaling", "dec.plan.deblock", "dec.upload"),
    "mc_ms": ("dec.inter",),
    "residual_recon_ms": ("dec.residual",),
    "intra_ms": ("dec.intra",),
    "edge_params_ms": ("dec.deblock.params",),
    "k2_ms": ("dec.deblock.filter",),
    "crop_ms": ("dec.deblock", "dec.deblock.crop"),
    "store_ms": ("dec.store",),
}


def recorded_decode(data, device):
    """One TorchDecoder decode of the stream under a sync=True recording
    of the port's tracer (losslessh264_tpu_torch/trace.py: each span
    starts and ends with a synchronize, so a stage holds its own device
    work). Returns (per decoded frame a row of DECODE_STAGE_SPANS'
    columns, `deblocked` whether K2 ran; the recording). A batch of
    all-intra frames has its shared stages on its first frame's row."""
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import trace
    with trace.recording(sync=True) as rec:
        dec = dt.TorchDecoder(data, device=device)
        for _ in dec.frames():
            pass
    # the frame ids in decode order; the last read found the stream's end
    per_frame = list(rec.by_frame().values())[:len(dec.routes)]
    rows = [dict(frame=i, deblocked="dec.deblock.filter" in ms,
                 **{col: sum(ms.get(n, 0.0) for n in names)
                    for col, names in DECODE_STAGE_SPANS.items()})
            for i, ms in enumerate(per_frame)]
    return rows, rec


def expected_launches(runs):
    """(K1, ..., K9, K11) launches that JaxEncoder's control flow implies for
    the encodes `runs` ((deblock_idc, kind, path, is_ref, intra MBs,
    references searched) each, from TorchEncoder.encodes and
    refs_searched): K1 once per P encode; K2 once per encode that
    deblocks, which is every encode with the filter on but a fused-path P
    frame that is not a reference and has no intra MB; K3 never (an
    encoder decodes nothing); K4 once per encode with an intra MB (every
    IDR, and each P frame with intra-fallback MBs); K5 once per reference
    a P encode searches; K6 and K7 never (an encoder decodes nothing); K8
    once per P encode, beside K1 in encode_inter_mbs; K9 wherever K2
    launches, just before it; K11 never (an encoder decodes nothing)."""
    k1 = sum(kind == "P" for _, kind, _, _, _, _ in runs)
    k2 = sum(idc != 1 and bool(path == "aq" or kind == "I" or is_ref
                               or n_intra)
             for idc, kind, path, is_ref, n_intra, _ in runs)
    k4 = sum(kind == "I" or n_intra > 0 for _, kind, _, _, n_intra, _ in runs)
    k5 = sum(refs for _, kind, _, _, _, refs in runs if kind == "P")
    return k1, k2, 0, k4, k5, 0, 0, k1, k2, 0


def refs_searched(enc, path, had_ref2):
    """The references a P encode of TorchEncoder `enc` searches (one K5
    launch each): two on the fused path of a refs=2 encoder whose second
    reference was set when encode_frame was called (`had_ref2`), else
    one (the per-MB QP path and the P runs search one)."""
    return 2 if path == "fused" and enc.refs == 2 and had_ref2 else 1


def encode_phase(frames, dev, card):
    """Phase 6: configurations A and B of the encode golden, and C, D and
    E of its sibling, on the card. `frames` are phase 5's decoded frames
    (host tensors), which that phase held to the NpDecoder CRCs the
    golden's source frames also match. Returns the K1-K11 launches of the
    encode pass, the number of frames encoded, and C's per-MB qp plane of
    its IDR (phase 13 holds K4 to its plain version on it)."""
    import hashlib
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import encoder_torch as et
    from losslessh264_tpu_torch import simulcast
    from losslessh264_tpu_torch.cases import golden_encoder
    configs = []
    for path, names in ((ENC_GOLDEN, "AB"), (ENC_GOLDEN_CDE, "CDE")):
        gold = json.load(open(path))
        configs += [(name, gold[name]) for name in names]
    W, H = gold["source"]["width"], gold["source"]["height"]
    src = [tuple(np.ascontiguousarray(p.numpy()) for p in f)
           for f in frames[:max(len(c["frames"]) for _, c in configs)]]

    def encode(cfg, stages):
        """(per-frame bytes (per layer for simulcast), per-frame recon of
        every layer on the card, wall s, stage rows, encodes run) of one
        encode of cfg's frames."""
        enc = golden_encoder(cfg, W, H, dev)
        layers = enc.encs if "simulcast" in cfg else [enc]
        out, recon, rows, runs, qp_planes = [], [], [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, f in enumerate(src[:len(cfg["frames"])]):
            for call in cfg.get("calls", {}).get(str(i), ()):
                getattr(enc, call)()
            if stages:
                for e in layers:
                    e.stages = et.StageTimer(dev)
            had_ref2 = [e._ref2 is not None for e in layers]
            out.append(enc.encode_frame_layers(*f) if "simulcast" in cfg
                       else enc.encode_frame(*f))
            recon.append([tuple(p.clone() for p in e.ref) for e in layers])
            qp_planes.append(getattr(enc, "_qp_plane", None))
            runs += [(e.deblock_idc,) + r + (refs_searched(e, r[1], h2),)
                     for e, h2 in zip(layers, had_ref2) for r in e.encodes]
            if stages:
                rows.append([e.stages.ms for e in layers])
        torch.cuda.synchronize()
        return out, recon, time.perf_counter() - t0, rows, runs, qp_planes

    def crc(planes):
        return zlib.crc32(b"".join(p.cpu().numpy().tobytes() for p in planes))

    def check(name, cfg, out, recon):
        for i, (data, rec, g) in enumerate(zip(out, recon, cfg["frames"])):
            per_layer = g["layers"] if "layers" in g else [g]
            data = data if "layers" in g else [data]
            for li, (d, r, gl) in enumerate(zip(data, rec, per_layer)):
                sha = hashlib.sha256(d).hexdigest()
                if (len(d), sha, crc(r)) != (gl["bytes"], gl["sha256"],
                                             gl["recon_crc32"]):
                    raise SystemExit(
                        f"encode {name} frame {i} layer {li}: {len(d)} bytes "
                        f"sha256 {sha[:16]} recon crc {crc(r)}, golden "
                        f"{gl['bytes']} bytes {gl['sha256'][:16]} crc "
                        f"{gl['recon_crc32']}")

    def closed_loop(name, cfg, out, recon):
        """The port's decoders on the card against the encoder: the recon
        after every reference frame (A, B: after every frame) and the JAX
        decoders' pictures of the golden (C, D: NpDecoder's; E:
        SimulcastDecoder's)."""
        if "simulcast" in cfg:
            streams = [b"".join(au[li] for au in out)
                       for li in range(len(out[0]))]
            pics = list(simulcast.SimulcastDecoder(
                streams, error_concealment=False, device=dev).frames())
        else:
            pics = list(dt.TorchDecoder(b"".join(out), device=dev,
                                        error_concealment=False).frames())
        if len(pics) != len(out):
            raise SystemExit(f"encode {name}: decoded {len(pics)} of "
                             f"{len(out)} frames")
        for i, pic in enumerate(pics):
            if "decoded_crc32" in cfg and crc(pic) != cfg["decoded_crc32"][i]:
                raise SystemExit(f"encode {name} frame {i}: decoded CRC "
                                 f"{crc(pic)}, the JAX decoder's "
                                 f"{cfg['decoded_crc32'][i]}")
            ref = cfg["frames"][i].get("is_ref", "layers" not in cfg[
                "frames"][i])
            if ref and not all(torch.equal(a, b)
                               for a, b in zip(pic, recon[i][0])):
                raise SystemExit(f"encode {name} frame {i}: the decoded "
                                 "frame differs from the encoder's recon")
        what = ("the JAX SimulcastDecoder's pictures" if "simulcast" in cfg
                else "the encoder's recon of every reference frame"
                + (" and NpDecoder's pictures" if "decoded_crc32" in cfg
                   else ""))
        log(f"encode {name}: the port's decoder on the card reproduces "
            f"{what} ({len(pics)} frames)")

    # pass 1: encode fps, the golden, the launch counts (set to 0 before
    # each configuration, checked against what its encodes imply)
    launches = dict.fromkeys(KERNELS, 0)
    streams, n_frames = {}, 0
    for name, cfg in configs:
        reset_launches()
        out, recon, wall, _, runs, qp_planes = encode(cfg, False)
        got = launches_now()
        check(name, cfg, out, recon)
        if name == "C":
            c_idr_qp = qp_planes[0].copy()
        streams[name] = (out, recon)
        n_frames += len(out)
        want = expected_launches(runs)
        sizes = [len(d) if isinstance(d, bytes) else [len(x) for x in d]
                 for d in out]
        log(f"encode {name} {cfg.get('kwargs', cfg.get('simulcast'))}: "
            f"{len(out)} frames {W}x{H} match the JAX golden (SHA-256 and "
            f"recon CRC32); {wall:.3f} s = {len(out) / wall:.4f} fps on "
            f"{card}; bytes {sizes}; "
            f"encodes (kind, path, is_ref, intra MBs, refs searched) "
            f"{[r[1:] for r in runs]}; launches {launch_str(got)}, implied "
            f"{launch_str(want)}")
        if got != want or want[0] == 0 or want[4] == 0:
            raise SystemExit(f"encode {name}: K1-K11 launched {got}, the "
                             f"encodes imply {want}")
        for k, v in zip(KERNELS, got):
            launches[k] += v
    log(f"launches during encode: {launch_str(launches.values())} for "
        f"{n_frames} frames")

    for name, cfg in configs:
        closed_loop(name, cfg, *streams[name])

    # pass 2: per-stage wall times of every frame (a synchronize ends
    # each stage)
    for name, cfg in configs:
        out, recon, wall, rows, _, _ = encode(cfg, True)
        check(name, cfg, out, recon)
        for i, per_layer in enumerate(rows):
            for li, ms in enumerate(per_layer):
                unknown = set(ms) - set(ENC_STAGES)
                if unknown:
                    raise SystemExit(f"encode: unlisted stages {unknown}")
                layer = f" layer {li}" if len(per_layer) > 1 else ""
                log(f"encode stage {name} frame {i}{layer}: " + json.dumps(
                    {k: round(ms.get(k, 0.0), 3) for k in ENC_STAGES})
                    + f" total {sum(ms.values()):.3f} ms on {card}")
        log(f"encode stage {name}: {wall:.3f} s for {len(out)} frames with "
            f"stage timing on {card}")
    return launches, n_frames, c_idr_qp


def older_encode_phase(frames, dev, card):
    """Phase 7: the older fixed-QP encoder (losslessh264_tpu_torch.encoder.
    Encoder: an I16x16 IDR, then P frames with the integer-pel window
    search on the card and the per-MB loops on the host) at 1280x720 on
    frames 0-2 of phase 5's decode, configuration F of
    tests/data/synth720p_enc_golden_f.json. Every frame's SHA-256 and
    reference CRC32 must equal the JAX golden, TorchDecoder on the card
    must decode the stream to the encoder's reference after every frame
    and to NpDecoder's pictures, and no kernel may launch (the streams
    switch the loop filter off, the search is integer-pel, and the older
    encoder's intra coding is its own host loop)."""
    import hashlib
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch.cases import golden_encoder
    gold = json.load(open(ENC_GOLDEN_F))
    cfg = gold["F"]
    W, H = gold["source"]["width"], gold["source"]["height"]
    src = [tuple(np.ascontiguousarray(p.numpy()) for p in f)
           for f in frames[:len(cfg["frames"])]]
    enc = golden_encoder(cfg, W, H, dev)
    reset_launches()
    out, refs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in src:
        out.append(enc.encode_frame(*f))
        refs.append(tuple(np.copy(p) for p in enc.ref))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches_now()
    for i, (d, ref, g) in enumerate(zip(out, refs, cfg["frames"])):
        sha = hashlib.sha256(d).hexdigest()
        c = zlib.crc32(b"".join(p.tobytes() for p in ref))
        if (len(d), sha, c) != (g["bytes"], g["sha256"], g["recon_crc32"]):
            raise SystemExit(f"older encoder frame {i}: {len(d)} bytes "
                             f"sha256 {sha[:16]} ref crc {c}, golden "
                             f"{g['bytes']} {g['sha256'][:16]} "
                             f"{g['recon_crc32']}")
    if got != (0,) * len(KERNELS):
        raise SystemExit(f"older encoder: K1-K11 launched {got}; the "
                         "integer-pel, unfiltered path (its window search "
                         "is not the dense one) launches none")
    split = {k: round(v, 3) for k, v in enc.times.items()}
    log(f"older encoder F {cfg['older']}: {len(out)} frames {W}x{H} match "
        f"the JAX golden; {wall:.3f} s = {len(out) / wall:.4f} fps on "
        f"{card}; ms: {json.dumps(split)} (me: the device search with its "
        f"upload and fetch; mb_loops: the host per-MB loops; write: MV "
        f"predictors and the native writer); bytes "
        f"{[len(d) for d in out]}; launches {launch_str(got)}")
    pics = [tuple(p.cpu().numpy() for p in pic) for pic in dt.TorchDecoder(
        b"".join(out), device=dev, error_concealment=False).frames()]
    for i, (pic, ref) in enumerate(zip(pics, refs)):
        c = zlib.crc32(b"".join(p.tobytes() for p in pic))
        if not all(np.array_equal(a, b) for a, b in zip(pic, ref)) or \
                c != cfg["decoded_crc32"][i]:
            raise SystemExit(f"older encoder frame {i}: the card's decode "
                             "differs from the encoder's reference or "
                             "NpDecoder's picture")
    if len(pics) != len(out):
        raise SystemExit(f"older encoder: decoded {len(pics)} frames")
    log(f"older encoder: TorchDecoder on the card reproduces the "
        f"encoder's reference and NpDecoder's picture of all {len(pics)} "
        f"frames")
    return dict(zip(KERNELS, got))


def gop_parallel_phase(data, golden, dec_launches, dev, card):
    """Phase 8: synth720p written twice in a row (2 GOPs, 50 frames),
    decoded by parallel.decode_yuv_gop_parallel with 2 workers (one
    TorchDecoder and one CUDA stream each), then by one sequential
    TorchDecoder: one pair keeps the smoke short (PERF.md has four runs
    in turns).
    Every frame's CRC32 must equal the NpDecoder golden, twice over, and
    each decode must launch K1-K9 and K11 twice as often as phase 5's."""
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import native
    from losslessh264_tpu_torch.parallel import decode_yuv_gop_parallel
    data2 = data + data
    starts = native.gop_starts(data2)
    if starts != [0, len(data)]:
        raise SystemExit(f"GOP starts of synth720p x2: {starts}")
    want = tuple(2 * v for v in dec_launches)

    def sequential():
        dec = dt.TorchDecoder(data2, device=dev)
        return [tuple(p.cpu().numpy() for p in f) for f in dec.frames()]

    def parallel():
        return decode_yuv_gop_parallel(data2, max_workers=2, device=dev)[0]

    fps = {"sequential": [], "parallel": []}
    launches = None
    for name, fn in (("parallel", parallel), ("sequential", sequential)):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_now()
        crcs = [zlib.crc32(b"".join(p.tobytes() for p in f)) for f in got]
        if crcs != golden + golden:
            bad = next(i for i, (a, b) in enumerate(zip(crcs + [None] * 50,
                                                         golden + golden))
                       if a != b)
            raise SystemExit(f"{name} decode of synth720p x2: {len(got)} "
                             f"frames, frame {bad} differs from the golden")
        if counts != want:
            raise SystemExit(f"{name} decode of synth720p x2 launched "
                             f"{counts}, expected {want}")
        if name == "parallel":
            launches = counts
        fps[name].append(len(got) / wall)
        log(f"gop-parallel phase: {name} decode of synth720p x2 ({len(got)} "
            f"frames, 2 GOPs) matches the CRCs; {wall:.3f} s = "
            f"{len(got) / wall:.3f} fps; launches {launch_str(counts)} on "
            f"{card}")
    rates = {k: [round(v, 4) for v in fs] for k, fs in fps.items()}
    log(f"gop-parallel decode, 2 workers on one card: {json.dumps(rates)} "
        f"fps (parallel first)")
    return dict(zip(KERNELS, launches))


def cli_phase(card):
    """Phase 9: the CLI's recompression verbs as subprocesses, through the
    port's own binding of the shared native layer (no device code): a
    4-shard compress of tests/data/walk_analog.264, which must equal
    native.compress_sharded and decompress to the input, and a 4-shard
    roundtrip, which must print bit-exact."""
    import tempfile
    from losslessh264_tpu_torch import native
    src = os.path.join(ROOT, "tests", "data", "walk_analog.264")
    data = open(src, "rb").read()
    env = dict(os.environ, PYTHONPATH=ROOT, CXX="g++")
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "walk_analog.pip")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "losslessh264_tpu_torch", src,
                        dst, "--shards", "4"], check=True, cwd=ROOT, env=env)
        t_compress = time.perf_counter() - t0
        pip = open(dst, "rb").read()
    if pip != native.compress_sharded(data, 4)[0]:
        raise SystemExit("CLI --shards 4: the .pip differs from "
                         "native.compress_sharded")
    if native.decompress(pip)[0] != data:
        raise SystemExit("CLI --shards 4: the .pip does not decompress to "
                         "the input")
    res = subprocess.run([sys.executable, "-m", "losslessh264_tpu_torch",
                          "roundtrip", src, "--shards", "4"], check=True,
                         cwd=ROOT, env=env, capture_output=True, text=True)
    line = res.stdout.strip().splitlines()[-1]
    if "bit-exact: YES" not in line:
        raise SystemExit(f"CLI roundtrip: {line}")
    log(f"CLI: compress --shards 4 of walk_analog.264 ({len(data)} -> "
        f"{len(pip)} bytes, {t_compress:.3f} s with verification) equals "
        f"native.compress_sharded and decompresses to the input; "
        f"roundtrip: {line} (host CPU of the machine of {card})")


def graft_phase(dev, card, mb_w=80, mb_h=45):
    """Phase 10: graft_entry.dryrun_multichip(2) on the card: two gloo
    ranks, each the encoder step at 80x45 MBs (encode_inter_mbs with K5
    and K1, _p_finish with K2, the coded-bits proxy) on its frame of a
    seeded batch, the bits all-reduced. Each rank's recY, mvx and bits
    must equal the same step run in this process, the reduced total their
    sum, and each rank must launch K1, K2 and K5 once; the step has no
    intra pass and decodes nothing, so its runs in this process launch
    neither K3, K4 nor K6."""
    from losslessh264_tpu_torch import graft_entry as ge
    reset_launches()
    t0 = time.perf_counter()
    ranks = ge.dryrun_multichip(2, device=dev.type, mb_w=mb_w, mb_h=mb_h)
    wall = time.perf_counter() - t0
    bits = []
    for rank, recY, mvx, rbits, total, k1, k2, k5, k8, k9, step_ms in ranks:
        want = ge.per_frame(mb_w, mb_h,
                            *ge.frame_args(mb_w, mb_h, 2, rank, dev))
        if not (np.array_equal(recY, want[0].cpu().numpy())
                and np.array_equal(mvx, want[1].cpu().numpy())
                and rbits == int(want[2])):
            raise SystemExit(f"graft rank {rank}: its step differs from the "
                             "same step in this process")
        if (k1, k2, k5, k8, k9) != (1, 1, 1, 1, 1):
            raise SystemExit(f"graft rank {rank}: K1/K2/K5/K8/K9 launched "
                             f"{(k1, k2, k5, k8, k9)}, once each expected")
        bits.append(rbits)
        log(f"graft rank {rank}: {mb_w}x{mb_h} MBs, recY {recY.shape}, "
            f"bits {rbits}, step {step_ms:.3f} ms (first call in the rank, "
            f"synchronized) on {card}")
    if any(r[4] != sum(bits) for r in ranks):
        raise SystemExit(f"graft: all-reduced totals {[r[4] for r in ranks]}"
                         f" != {sum(bits)}")
    # the step's warm time in this process
    args = ge.frame_args(mb_w, mb_h, 2, 0, dev)
    step = cuda_ms(lambda: ge.per_frame(mb_w, mb_h, *args), 5, warmup=1)
    k3, k4, k6, k7, k11 = (launches_now()[i] for i in (2, 3, 5, 6, 9))
    if (k3, k4, k6, k7, k11) != (0, 0, 0, 0, 0):
        raise SystemExit(f"graft: the step launched K3/K4/K6/K7/K11 "
                         f"{(k3, k4, k6, k7, k11)}")
    log(f"graft dryrun: 2 ranks, total bits {sum(bits)} == the all-reduce; "
        f"{wall:.3f} s with process start; warm step {step:.3f} ms per rank "
        f"frame (CUDA events) on {card}")
    return {"K1": sum(r[5] for r in ranks), "K2": sum(r[6] for r in ranks),
            "K3": k3, "K4": k4, "K5": sum(r[7] for r in ranks), "K6": k6,
            "K7": k7, "K8": sum(r[8] for r in ranks),
            "K9": sum(r[9] for r in ranks), "K11": k11}


def runs_routes(gold):
    """The intra route TorchDecoder takes for each frame of runs720p, from
    its golden's plan (tools/gen_run_streams.py): the leading all-intra
    frames one batch, then per P frame none, the populated diagonals
    (kinds 1, 2) or the full table (kind 3)."""
    lead = next(i for i, r in enumerate(gold["intra"]) if not r["all_intra"])
    n_diags = 2 * (gold["luma_shape"][0] // 16 - 1) + \
        gold["luma_shape"][1] // 16
    return [("batch", lead)] * lead + [
        {0: ("none", 0), 1: ("sparse", r["rows"]), 2: ("sparse", r["rows"]),
         3: ("full", n_diags)}[r["kind"]] for r in gold["intra"][lead:]]


def runs_intra_rows(data, routes, dev):
    """Each frame of runs720p with its intra ms on its route, from a
    sync=True recording of a TorchDecoder decode (the batch's one pass
    split over its frames; the K3 launch over the leading all-intra
    frames together, one per P frame with intra MBs), beside the plain
    compact-carry pass over the full table on the same planes (one frame
    at a time), which a second decode runs on the inputs of every intra
    pass, ahead of the route's, and which the route's result must
    equal. Returns the rows and the K1, K6 and K11 launches that the
    frames' MC plans imply (K6 once per bucketed P frame, K1 once per ring
    slot such a frame reads, K11 once per P frame on the per-cell
    route)."""
    from losslessh264_tpu_torch import decoder_torch as dt

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    _, rec = recorded_decode(data, dev)
    plain_ms = []   # per frame with an intra pass, in decode order
    saved = {k: getattr(dt, k) for k in ("_intra_scan",
                                         "_intra_scan_sparse")}

    def held(scan):
        def run(mb_w, mb_h, Yw, Uw, Vw, ry, ru, rv, p, diags):
            full = dt.diagonals(mb_w, mb_h)
            batch = Yw.dim() == 3
            work = [(Yw, Uw, Vw, ry, ru, rv)]
            ps = [p]
            if batch:
                work = list(zip(Yw, Uw, Vw, ry, ru, rv))
                ps = [{k: v[i] for k, v in p.items()}
                      for i in range(len(work))]
            t0 = now()
            singles = [dt._intra_scan_plain(
                mb_w, mb_h, *(a.clone() for a in w), q, full)
                for w, q in zip(work, ps)]
            plain_ms.extend([(now() - t0) * 1e3 / len(work)] * len(work))
            routed = scan(mb_w, mb_h, Yw, Uw, Vw, ry, ru, rv, p, diags)
            for i, single in enumerate(singles):
                got = [a[i] for a in routed] if batch else routed
                if not all(torch.equal(a, b) for a, b in zip(got, single)):
                    raise SystemExit(
                        f"runs720p: K3 on the {scan.__name__} route "
                        f"differs from the plain pass (pass "
                        f"{len(plain_ms) - len(work) + i})")
            return routed
        return run

    for name, fn in saved.items():
        setattr(dt, name, held(fn))
    try:
        for _ in dt.TorchDecoder(data, device=dev).frames():
            pass
    finally:
        for name, fn in saved.items():
            setattr(dt, name, fn)
    per_frame = list(rec.by_frame().values())[:len(routes)]
    lead = routes.count(routes[0]) if routes[0][0] == "batch" else 0
    rows, passes = [], iter(plain_ms)
    for i, (ms, route) in enumerate(zip(per_frame, routes)):
        # the batch's spans carry its first frame's id
        intra = (per_frame[0]["dec.intra"] / lead if i < lead
                 else ms.get("dec.intra", 0.0))
        plain = next(passes) if route[0] != "none" else 0.0
        rows.append(dict(frame=i, route=route, intra_ms=intra,
                         plain_ms=plain))
    return (rows, rec.counters.get("dec.mc_slots", 0),
            rec.counters.get("dec.mc_bucketed", 0),
            rec.counters.get("dec.mc_cells", 0))


def runs_decode_phase(dev, card):
    """Phase 11: tests/data/runs720p.264 (tools/gen_run_streams.py) on the
    card: four IDRs that TorchDecoder decodes as one batch
    (recon_intra_batch), then P frames whose intra MBs populate no
    diagonal, 1, 8 or 42 of the 168 (no pass, the sparse pass over the
    populated ones, the full table). Every frame's CRC32 must equal
    NpDecoder's, each frame must take its route, K2 must launch once per
    deblocked frame, K1, K6 and K11 as the frames' MC plans imply and K3
    once per route that has an intra pass (the batch once). Then a recorded
    decode prints each frame's intra ms on its route (K3) beside the
    plain full-table pass on the same planes (runs_intra_rows)."""
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import native
    data = open(RUNS_STREAM, "rb").read()
    gold = json.load(open(RUNS_GOLDEN))["runs720p"]
    routes = runs_routes(gold)
    deblocked = sum(bool(dt.TorchDecoder._needs_deblock(
        f, dt.TorchDecoder._nnz_plane(f))) for f in native.SymbolDecoder(data))
    # K3: one launch for the batch, one per P frame with an intra pass
    k3 = (routes[0][0] == "batch") + sum(r[0] in ("sparse", "full")
                                         for r in routes)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = dt.TorchDecoder(data, device=dev)
    frames = [tuple(a.cpu() for a in yuv) for yuv in dec.frames()]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches_now()
    crcs = [zlib.crc32(b"".join(p.numpy().tobytes() for p in f))
            for f in frames]
    if crcs != gold["crc32"]:
        bad = [i for i, (a, b) in enumerate(zip(crcs, gold["crc32"]))
               if a != b]
        raise SystemExit(f"runs720p: {len(frames)} frames, CRCs differ from "
                         f"NpDecoder's at frames {bad}")
    if dec.routes != routes:
        raise SystemExit(f"runs720p routes {dec.routes}, expected {routes}")
    rows, k1, k6, k11 = runs_intra_rows(data, routes, dev)
    want = (k1, deblocked, k3, 0, 0, k6, len(frames), 0, deblocked, k11)
    if got != want or k6 == 0 or k11 == 0:
        raise SystemExit(f"runs720p: K1-K11 launched {got}, the frames imply "
                         f"{want}")
    log(f"runs decode: {len(frames)} frames of runs720p match the NpDecoder "
        f"CRCs; {wall:.3f} s = {len(frames) / wall:.3f} fps on {card}; "
        f"routes {dec.routes}; launches {launch_str(got)}, implied "
        f"{launch_str(want)}")
    for r in rows:
        log("runs stage " + json.dumps(
            {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in r.items()}) + f" on {card}")
    for name in ("batch", "sparse", "full"):
        sel = [r for r in rows if r["route"][0] == name]
        if sel:
            route = sum(r["intra_ms"] for r in sel) / len(sel)
            plain = sum(r["plain_ms"] for r in sel) / len(sel)
            log(f"runs intra route {name}: {len(sel)} frames, K3 {route:.3f} "
                f"ms per frame against {plain:.3f} ms for the plain "
                f"full-table pass on the same planes on {card}")
    return dict(zip(KERNELS, got))


def encode_runs_phase(frames, dev, card):
    """Phase 12: configuration G of tests/data/synth720p_enc_golden_g.json
    (A's settings) on frames 0-6 of phase 5's decode:
    TorchEncoder.encode_frames(frames, batch=3), an IDR and two runs of 3
    P frames, each run written on the writer thread while the next one's
    device work goes on. Every frame's SHA-256 must equal the golden, the
    recon after it the golden's run_recon_crc32, frames 0-3 golden A's
    too, and K1 / K2 / K4 / K5 launch as the encodes imply. Then the 6 P
    frames
    again from the IDR's state (load_state), in turns one encode_frame
    each and through encode_frames(batch=3), each turn held to the
    golden (per frame: bytes; the recon after each frame, or after the
    runs): P-frame fps of both, and the writer's time in the runs against
    the time the caller waited for it."""
    import hashlib
    from losslessh264_tpu_torch.cases import golden_encoder
    gold = json.load(open(ENC_GOLDEN_G))
    cfg = gold["G"]
    gold_a = json.load(open(ENC_GOLDEN))["A"]["frames"]
    W, H = gold["source"]["width"], gold["source"]["height"]
    src = [tuple(np.ascontiguousarray(p.numpy()) for p in f)
           for f in frames[:len(cfg["frames"])]]

    def crc(planes):
        return zlib.crc32(b"".join(p.cpu().numpy().tobytes() for p in planes))

    def check(what, out, first=0):
        for i, d in enumerate(out, first):
            g = cfg["frames"][i]
            sha = hashlib.sha256(d).hexdigest()
            if (len(d), sha) != (g["bytes"], g["sha256"]) or (
                    i < len(gold_a) and sha != gold_a[i]["sha256"]):
                raise SystemExit(f"encode G {what} frame {i}: {len(d)} bytes "
                                 f"sha256 {sha[:16]}, golden {g['bytes']} "
                                 f"{g['sha256'][:16]}")

    reset_launches()
    enc = golden_encoder(cfg, W, H, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = enc.encode_frames(src, batch=cfg["batch"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches_now()
    runs = [(enc.deblock_idc,) + r + (refs_searched(enc, r[1], False),)
            for r in enc.encodes]
    want = expected_launches(runs)
    check("encode_frames", out)
    if crc(enc.ref) != cfg["run_recon_crc32"]:
        raise SystemExit("encode G: the recon after encode_frames differs "
                         "from the golden")
    if [r[2] for r in runs] != ["fused"] + ["run"] * 6 or got != want:
        raise SystemExit(f"encode G: encodes {[r[1:] for r in runs]}, "
                         f"K1-K11 launched {got}, implied {want}")
    log(f"encode G {cfg['kwargs']} batch {cfg['batch']}: {len(out)} frames "
        f"{W}x{H} match the JAX golden (SHA-256, the recon after the runs; "
        f"frames 0-3 golden A's); {wall:.3f} s = {len(out) / wall:.4f} fps "
        f"on {card}; encodes (kind, path, is_ref, intra MBs, refs searched) "
        f"{[r[1:] for r in runs]}; launches {launch_str(got)}, implied "
        f"{launch_str(want)}; writer {json.dumps(enc.prof)}")

    # the P frames in turns: one encode_frame each, then runs, runs, one
    # each; the first turn encodes the IDR whose state the others load
    state = None
    fps = {"per_frame": [], "runs": []}
    hidden = []
    for turn in ("per_frame", "runs", "runs", "per_frame"):
        e = golden_encoder(cfg, W, H, dev)
        if state is None:
            check("IDR", [e.encode_frame(*src[0])])
            if crc(e.ref) != cfg["frames"][0]["recon_crc32"]:
                raise SystemExit("encode G: the IDR's recon differs")
            state = tuple(p.cpu().numpy() for p in e.ref)
        else:
            e.load_state(state, frame_idx=1, frame_num=1, idr_id=1)
        recon = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if turn == "runs":
            out = e.encode_frames(src[1:], batch=cfg["batch"])
        else:
            out = []
            for f in src[1:]:
                out.append(e.encode_frame(*f))
                recon.append(tuple(p.clone() for p in e.ref))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(turn, out, first=1)
        crcs = [crc(r) for r in recon] or [crc(e.ref)]
        if crcs != [g["recon_crc32"] for g in cfg["frames"][
                len(cfg["frames"]) - len(crcs):]]:
            raise SystemExit(f"encode G {turn}: recon differs from the "
                             "golden")
        fps[turn].append(len(out) / wall)
        msg = ""
        if turn == "runs":
            hidden.append(e.prof["entropy_ms"] - e.prof["writer_wait_ms"])
            msg = (f"; writer thread {e.prof['entropy_ms']:.3f} ms, caller "
                   f"waited {e.prof['writer_wait_ms']:.3f} ms for it")
        log(f"encode G P frames 1-6 {turn}: {wall:.3f} s = "
            f"{len(out) / wall:.4f} fps on {card}{msg}")
    log(f"encode G P-frame fps in turns: {json.dumps(fps)}; per run turn "
        f"the writer thread's ms less the ms the caller waited for it (at "
        f"most the writer time that left the critical path): "
        f"{[round(h, 3) for h in hidden]} on {card}")
    return dict(zip(KERNELS, got))


# K3 / K4 random cases (as tests/test_torch_kernels.py's): K3 (mb_w, mb_h,
# B, seed, options of cases.random_intra_case: a 720p frame of I4x4 MBs
# only), K4 (mb_w, mb_h, seed, qp, intra mask of random_intra_encode_case;
# odd seeds encode half the MBs, "stripes" two MBs in three along a row)
K3_CASES = [(9, 4, 1, 0, {}), (9, 4, 4, 1, {}), (22, 18, 1, 2, {}),
            (80, 45, 1, 3, {}), (80, 45, 4, 4, {}), (1, 9, 2, 5, {}),
            (7, 1, 3, 6, {}), (80, 45, 1, 7, {"classes": (0,), "t8_share": 0}),
            (80, 1, 1, 8, {}), (1, 45, 1, 9, {})]
K4_CASES = [(9, 4, 0, 26, None), (9, 4, 1, "aq", None), (22, 18, 2, 0, None),
            (80, 45, 4, 28, None), (80, 45, 5, "aq", None),
            (1, 9, 6, 51, None), (7, 1, 7, 26, None), (80, 45, 8, 0, None),
            (80, 45, 10, 51, None), (80, 45, 12, 28, "stripes"),
            (80, 1, 14, 26, None), (1, 45, 16, 26, None)]
# integer operations per intra MB (estimates from the kernels' code, for
# the bound): K3 ~12 per luma and chroma sample of the coded mode (a
# table row: 3 products, 3 sums, a shift, the residual, two clamps) plus
# the edges, ~5000; K4 the I4x4 search (16 blocks x 9 modes x 16 samples
# x ~12), the I16x16 and chroma SADs of 4 modes (~3 per sample) and the
# transforms (~200 per 4x4 block), ~48000
K3_OPS_PER_MB = 5000
K4_OPS_PER_MB = 48000


def k3_bytes(mb_w, mb_h, B, n_intra):
    """Bytes K3 must move: the int32 working planes (WPAD margin
    included: they are the function's input and output) read and written
    once, and the residuals and MB rows of the intra MBs read once."""
    from losslessh264_tpu_torch.ops import intra as tintra
    plane = ((16 * mb_h + 16) * (16 * mb_w + 16)
             + 2 * (8 * mb_h + 16) * (8 * mb_w + 16))
    return 2 * 4 * B * plane + 4 * n_intra * (256 + 128 + tintra.K3_INFO_W)


def k4_bytes(mb_w, mb_h, n_intra):
    """Bytes K4 must move: the uint8 source and recon planes once each,
    the inter tiles of the MBs that are not intra, qp and qpc of the intra
    MBs, and the [n, 427] int32 symbol rows written once."""
    n = mb_w * mb_h
    pixels = 256 * n * 3 // 2
    return (2 * pixels + 4 * (n - n_intra) * 384 + 8 * n_intra
            + 4 * n * 427)


def chain_steps(mb_w, mb_h):
    """Dependent MB steps of a slope-2 wavefront frame: its non-empty
    diagonals (one MB column has one MB per row)."""
    return mb_h if mb_w == 1 else 2 * (mb_h - 1) + mb_w


def synth_intra_inputs(data, dev):
    """The intra pass's inputs of every synth720p frame with intra MBs
    (frames 0, 10 and 20), from a decode by hand along _decode_one:
    (frame, (Yw, Uw, Vw, res_y, res_u, res_v), the INTRA_KEYS planes)."""
    from losslessh264_tpu_torch import decoder_torch as dt
    dec = dt.TorchDecoder(data, device=dev)
    out = []
    for i, f in enumerate(dec.sym):
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        dec._prep_refs(mb_w, mb_h)
        planes_np, diags, has_intra, full = dec._prep_planes(f)
        p = dt.planes_to_torch(planes_np, dev)
        work = dt._residual_and_inter(mb_w, mb_h, p, dec.ref_y, dec.ref_u,
                                      dec.ref_v)
        planes = work[:3]
        if has_intra:
            out.append((i, work, {k: p[k] for k in dt.INTRA_KEYS}))
            scan = dt._intra_scan if full else dt._intra_scan_sparse
            planes = scan(mb_w, mb_h, *work, p, diags)
        if dec._needs_deblock(f, planes_np["nnz"]):
            yuv = dt._deblock_crop(mb_w, mb_h, *planes, p)
        else:
            yuv = dt._crop(mb_w, mb_h, *planes)
        dec._finish_frame(f, *yuv, False)
    return out


def encode_args(case, dev):
    """intra_wavefront's arguments after (mb_w, mb_h) from a
    cases.random_intra_encode_case on the card."""
    def T(k):
        return torch.as_tensor(case[k], device=dev)
    return (T("srcY"), T("srcU"), T("srcV"), T("inter_y"), T("inter_u"),
            T("inter_v"), case["is_intra"], T("qp"), T("qpc"),
            case["row_slice"])


def idr_args(cfg, frame, qp_plane, dev):
    """intra_wavefront's arguments after (mb_w, mb_h) for an IDR of
    configuration `cfg` on `frame` (host Y, U, V): the encoder's own flat
    (qp, qpc) planes, or the per-MB qp plane `qp_plane` with its chroma
    qp, and the encoder's row_slice."""
    from losslessh264_tpu_torch.cases import golden_encoder
    from losslessh264_tpu_torch.ref_np import CHROMA_QP
    H, W = frame[0].shape
    enc = golden_encoder(cfg, W, H, dev)
    n = (H // 16) * (W // 16)
    if qp_plane is None:
        qp, qpc = enc._qp_maps()
    else:
        qp_plane = np.asarray(qp_plane, np.int64)
        qp = torch.as_tensor(qp_plane.astype(np.int32), device=dev)
        qpc = torch.as_tensor(CHROMA_QP[qp_plane].astype(np.int32),
                              device=dev)
    z16 = torch.zeros((n, 16, 16), dtype=torch.int32, device=dev)
    z8 = torch.zeros((n, 8, 8), dtype=torch.int32, device=dev)
    return (*(p.to(dev) for p in frame), z16, z8, z8, np.ones(n, bool), qp,
            qpc, enc._row_slice_np)


def k3_launchers(lib, mb_w, mb_h, work, p, count):
    """`count` no-argument calls of lib's bare K3 entry (pip_intra_dec),
    each on its own copy of the working planes (the kernel writes them in
    place)."""
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch.ops import intra as tintra
    ops = tintra.k3_operands(mb_w, mb_h, *work, p)
    B = ops[0].shape[0]
    calls = []
    for _ in range(count):
        mine = [a.clone() for a in ops[:3]] + list(ops[3:8]) + [
            torch.empty_like(ops[8])]

        def run(mine=mine):
            _build.check(lib.pip_intra_dec(
                *(ctypes.c_void_p(a.data_ptr()) for a in mine), mb_w, mb_h,
                B, _build.stream(mine[0].device)), "intra")
        calls.append(run)
    return calls


def k4_launchers(lib, mb_w, mb_h, args, count):
    """`count` no-argument calls of lib's bare K4 entry (pip_intra_enc),
    each on its own copy of the working planes and symbol rows."""
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch import encoder_torch as et
    ops = et.k4_operands(mb_w, mb_h, *args)
    calls = []
    for _ in range(count):
        mine = [a.clone() for a in ops[:3]] + list(ops[3:10]) + [
            ops[10].clone(), torch.empty_like(ops[11])]

        def run(mine=mine):
            _build.check(lib.pip_intra_enc(
                *(ctypes.c_void_p(a.data_ptr()) for a in mine), mb_w, mb_h,
                _build.stream(mine[0].device)), "intra encode")
        calls.append(run)
    return calls


# the 720p wavefront's MB row (never waits: the MB's own compute) and MB
# column (waits on the row above at every MB: compute and hand-off), on
# the cases tools/kernel_ab.py k3|k4 times: K3 random_intra_case seeds 1
# and 2, K4 random_intra_encode_case seeds 2 and 4 (all intra) at qp 28
SPLIT_SHAPES = (("row_80x1", 80, 1, 1), ("column_1x45", 1, 45, 2))


def split_times(kernel, lib, dev, card):
    """Kernel-alone ms of K3 or K4 on SPLIT_SHAPES, and us per MB of the
    shape's chain (CUDA events, each launch on its own planes)."""
    from losslessh264_tpu_torch.cases import (random_intra_case,
                                              random_intra_encode_case)
    out = {}
    for name, mb_w, mb_h, seed in SPLIT_SHAPES:
        if kernel == "K3":
            case = random_intra_case(mb_w, mb_h, 1, seed, dev)
            calls = k3_launchers(lib, mb_w, mb_h, case[:6], case[6], 22)
        else:
            args = encode_args(random_intra_encode_case(mb_w, mb_h, 2 * seed,
                                                        28), dev)
            calls = k4_launchers(lib, mb_w, mb_h, args, 22)
        ms = cuda_ms_each(calls)
        out[f"{name}_ms"] = ms
        out[f"{name}_us_per_mb"] = ms * 1e3 / chain_steps(mb_w, mb_h)
        log(f"time {kernel} alone, {mb_w}x{mb_h} MBs: {ms:.4f} ms = "
            f"{out[f'{name}_us_per_mb']:.3f} us per MB on {card}")
    return out


def intra_kernels_phase(data, frames, c_idr_qp, dev, card):
    """Phase 13: K3 (csrc/intra_dec.cu) and K4 (csrc/intra_enc.cu)
    against their plain versions on the card, torch.equal on every
    output: K3 on the random cases of K3_CASES (5 launches each) and on
    the intra pass of synth720p's frames 0, 10 and 20; K4 on K4_CASES (3
    launches each), A's IDR (frame 0 of phase 5's decode at A's flat qp)
    and C's per-MB-QP IDR (the same frame at the qp plane C's IDR used in
    phase 6). Then their times at 720p: `ms` the wrapper (CUDA events
    around back-to-back calls), `kernel_ms` the bare C entry (CUDA events,
    each launch on its own copy of the planes), `plain_ms` the plain
    version, beside the byte and operation bounds and the chain of
    dependent MB steps. Returns the K3 and K4 rows of the kernel report."""
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import encoder_torch as et
    from losslessh264_tpu_torch.cases import (random_intra_case,
                                              random_intra_encode_case)
    from losslessh264_tpu_torch.ops import intra as tintra
    lib = _build.lib()

    def same(got, want, what):
        torch.cuda.synchronize()
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{what}: the kernel differs from its plain "
                             f"version (max abs err {err})")
        return err

    k3_err = k4_err = 0
    for mb_w, mb_h, B, seed, opts in K3_CASES:
        case = random_intra_case(mb_w, mb_h, B, seed, dev, **opts)
        want = dt._intra_scan_plain(mb_w, mb_h, *case,
                                    dt.diagonals(mb_w, mb_h))
        for _ in range(5):
            k3_err = max(k3_err, same(tintra.intra_recon(mb_w, mb_h, *case),
                                      want, f"K3 {mb_w}x{mb_h} B {B}"))
        log(f"K3 intra_recon == plain: {mb_w}x{mb_h} MBs x {B} frames seed "
            f"{seed}{' ' + str(opts) if opts else ''}, 5 launches")
    synth = synth_intra_inputs(data, dev)
    for i, work, p in synth:
        want = dt._intra_scan_plain(80, 45, *work, p, dt.diagonals(80, 45))
        k3_err = max(k3_err, same(tintra.intra_recon(80, 45, *work, p), want,
                                  f"K3 synth720p frame {i}"))
        n_intra = int(sum((p["mb_class"] == c).sum() for c in (0, 1, 2)))
        log(f"K3 intra_recon == plain: synth720p frame {i} ({n_intra} intra "
            f"MBs)")
    for mb_w, mb_h, seed, qp, mask in K4_CASES:
        args = encode_args(random_intra_encode_case(mb_w, mb_h, seed, qp,
                                                    mask), dev)
        want = et.intra_wavefront_plain(mb_w, mb_h, *args)
        for _ in range(3):
            k4_err = max(k4_err, same(et.intra_wavefront(mb_w, mb_h, *args),
                                      want, f"K4 {mb_w}x{mb_h} qp {qp}"))
        log(f"K4 intra_wavefront == plain: {mb_w}x{mb_h} MBs seed {seed} qp "
            f"{qp}{' ' + mask if mask else ''}, 3 launches")
    gold = json.load(open(ENC_GOLDEN))
    gold_c = json.load(open(ENC_GOLDEN_CDE))
    idrs = {"A": idr_args(gold["A"], frames[0], None, dev),
            "C": idr_args(gold_c["C"], frames[0], c_idr_qp, dev)}
    idr_plain = {}
    for name, args in idrs.items():
        t0 = time.perf_counter()
        want = et.intra_wavefront_plain(80, 45, *args)
        torch.cuda.synchronize()
        idr_plain[name] = (time.perf_counter() - t0) * 1e3
        k4_err = max(k4_err, same(et.intra_wavefront(80, 45, *args), want,
                                  f"K4 {name}'s IDR"))
        qps = sorted(set(args[7].cpu().tolist()))
        log(f"K4 intra_wavefront == plain: {name}'s IDR, 1280x720, qp "
            f"{qps[0]}..{qps[-1]} ({len(qps)} values), plain "
            f"{idr_plain[name]:.1f} ms")

    # ---- times at 720p (80x45 MBs) ----
    i0, work0, p0 = synth[0]
    n_intra0 = int(sum((p0["mb_class"] == c).sum() for c in (0, 1, 2)))
    k3 = {"ms": cuda_ms(lambda: tintra.intra_recon(80, 45, *work0, p0), 20),
          "kernel_ms": cuda_ms_each(k3_launchers(lib, 80, 45, work0, p0, 22)),
          "plain_ms": cuda_ms(lambda: dt._intra_scan_plain(
              80, 45, *work0, p0, dt.diagonals(80, 45)), 2, warmup=0),
          "chain_steps": chain_steps(80, 45), "intra_mbs": n_intra0}
    k3["bound_ms"], k3["bound_by"] = bound_ms(
        k3_bytes(80, 45, 1, n_intra0), n_intra0 * K3_OPS_PER_MB)
    k3["bytes"] = k3_bytes(80, 45, 1, n_intra0)
    k3["byte_bound_ms"] = k3["bytes"] / HBM_BYTES_PER_S * 1e3
    per_frame = {}
    for i, work, p in synth[1:]:
        per_frame[f"frame_{i}_ms"] = cuda_ms(
            lambda: tintra.intra_recon(80, 45, *work, p), 10)
    case = random_intra_case(80, 45, 4, 4, dev)
    per_frame["batch4_ms_per_frame"] = cuda_ms(
        lambda: tintra.intra_recon(80, 45, *case), 10) / 4
    k3["per_frame"] = per_frame
    k3.update(split_times("K3", lib, dev, card))
    log(f"time K3 intra_recon, synth720p frame {i0} (80x45 MBs, {n_intra0} "
        f"intra): wrapper {k3['ms']:.4f} ms, kernel alone "
        f"{k3['kernel_ms']:.4f} ms = "
        f"{k3['kernel_ms'] * 1e3 / k3['chain_steps']:.3f} us per step of "
        f"the {k3['chain_steps']}-MB chain; bound {k3['bound_ms']:.5f} ms by "
        f"{k3['bound_by']} ({k3['bytes']} bytes); plain torch "
        f"{k3['plain_ms']:.1f} ms; {json.dumps(per_frame)} on {card}")
    argsA = idrs["A"]
    k4 = {"ms": cuda_ms(lambda: et.intra_wavefront(80, 45, *argsA), 10),
          "kernel_ms": cuda_ms_each(k4_launchers(lib, 80, 45, argsA, 12)),
          "plain_ms": idr_plain["A"], "chain_steps": chain_steps(80, 45),
          "intra_mbs": 3600,
          "c_idr_ms": cuda_ms(lambda: et.intra_wavefront(80, 45, *idrs["C"]),
                              10)}
    k4.update(split_times("K4", lib, dev, card))
    k4["bound_ms"], k4["bound_by"] = bound_ms(k4_bytes(80, 45, 3600),
                                              3600 * K4_OPS_PER_MB)
    k4["bytes"] = k4_bytes(80, 45, 3600)
    k4["byte_bound_ms"] = k4["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"time K4 intra_wavefront, A's IDR (80x45 MBs, all intra): wrapper "
        f"{k4['ms']:.4f} ms (C's IDR {k4['c_idr_ms']:.4f}), kernel alone "
        f"{k4['kernel_ms']:.4f} ms = "
        f"{k4['kernel_ms'] * 1e3 / k4['chain_steps']:.3f} us per step of "
        f"the {k4['chain_steps']}-MB chain; bound {k4['bound_ms']:.5f} ms by "
        f"{k4['bound_by']} ({3600 * K4_OPS_PER_MB} ops; {k4['bytes']} bytes "
        f"take {k4['byte_bound_ms']:.5f} ms); plain torch "
        f"{k4['plain_ms']:.1f} ms on {card}")
    k3["max_abs_err"], k4["max_abs_err"] = k3_err, k4_err
    return k3, k4


def k5_bytes_ops(H, W, R, cur_bytes):
    """(bytes, operations) K5 must take: the source read once (in its
    dtype), the reference window once, the 27n int32 outputs written
    once; an absolute difference, its sum and the running compare for
    every pixel at every displacement."""
    n = (H // 16) * (W // 16)
    n_bytes = cur_bytes * H * W + (H + 2 * R) * (W + 2 * R) + 4 * 27 * n
    return n_bytes, 3 * (2 * R + 1) ** 2 * H * W


def k6_luma_need(fx, fy):
    """[B, 9, 9] bool: the samples of a fix-up cell's 9x9 window (rows
    and columns from 2 before the cell to 3 after it) that its
    quarter-pel case (fx, fy, [B] each) reads: G alone, a b row or an h
    column of 6-tap sums, both (the diagonals: the nearest b row and h
    column), or the whole window (j)."""
    k = np.arange(9)

    def row_of(lo):                   # 4 rows (or columns) from lo
        return (k >= lo) & (k < lo + 4)
    need = np.zeros((len(fx), 9, 9), bool)
    for i, (x, y) in enumerate(zip(fx, fy)):
        if x == 0 and y == 0:
            need[i] = row_of(2)[:, None] & row_of(2)[None, :]
        elif y == 0:
            need[i] = row_of(2)[:, None]
        elif x == 0:
            need[i] = row_of(2)[None, :]
        elif x == 2 or y == 2:
            need[i] = True
        else:
            need[i] = (row_of(2 if y == 1 else 3)[:, None]
                       | row_of(2 if x == 1 else 3)[None, :])
    return need


def k6_reads(ref_y, ref_u, pad, p, mb_w, mb_h):
    """The samples the frame's prediction under the plan `p` depends on,
    each once: (hp, luma, chroma, table cells, fix-up cells). hp [2, 4,
    Ho, Wo] marks the samples of K1's planes of the two active slots that
    some table cell's luma tap reads (a sample two taps or two cells
    share marked once); luma [R, Hp, Wp] the ring's luma samples some
    fix-up cell's quarter-pel case reads (k6_luma_need); chroma [R, Hcp,
    Wcp] the U (and so V) samples some cell's eighth-pel bilinear weighs
    by more than 0 (the right column only if fx > 0, the lower row only
    if fy > 0)."""
    H, W = 16 * mb_h, 16 * mb_w
    R, Hp, Wp = ref_y.shape
    cpad = pad // 2
    lpad = 2 * cpad
    Hc, Wc = H // 2, W // 2
    o3 = np.arange(3)
    bucket = p["mc_bucket"].cpu().numpy().reshape(
        mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3).reshape(4 * mb_h, 4 * mb_w)
    nuniq = int(p["mc_nuniq"])
    slots = np.asarray(p["mc_slots"]).astype(np.int64)
    act = [int(slots[0]), int(slots[1]) if p["mc_nslots"] > 1
           else int(slots[0])]
    chroma = np.zeros(ref_u.shape, bool)

    def mark_chroma(slot, y, x, fy, fx):
        """each cell's 2x2 bilinear at chroma (y, x) with fractions fy, fx
        ([B] each): the samples it weighs by more than 0"""
        keep = ((o3[None, :, None] < 2 + (fy > 0)[:, None, None])
                & (o3[None, None, :] < 2 + (fx > 0)[:, None, None]))
        ys = np.broadcast_to(y[:, None, None] + o3[None, :, None],
                             keep.shape)
        xs = np.broadcast_to(x[:, None, None] + o3[None, None, :],
                             keep.shape)
        ss = np.broadcast_to(slot[:, None, None], keep.shape)
        chroma[ss[keep], ys[keep], xs[keep]] = True

    # table cells: two taps of K1's planes, the bilinear of their slot
    cr, cc = np.nonzero(bucket < nuniq)
    e = np.asarray(p["mc_uniq"]).astype(np.int64)[bucket[cr, cc]]
    o4 = np.arange(4)
    hp = np.zeros((2, 4, Hp - 5, Wp - 5), bool)
    for pl, dy, dx in ((3, 4, 5), (6, 7, 8)):
        ys = (pad - 2 + e[:, 1] + 4 * cr + e[:, dy])[:, None, None] \
            + o4[None, :, None]
        xs = (pad - 2 + e[:, 2] + 4 * cc + e[:, dx])[:, None, None] \
            + o4[None, None, :]
        hp[e[:, 0][:, None, None], e[:, pl][:, None, None], ys, xs] = True
    mark_chroma(np.array(act)[e[:, 0]], cpad + e[:, 9] + 2 * cr,
                cpad + e[:, 10] + 2 * cc, e[:, 11], e[:, 12])

    # fix-up cells: the general prediction from the raw rings, as
    # ops/mc.mc_luma_cells and mc_chroma_cells clip and read
    fix = p["mc_fix"].cpu().numpy()
    fix = fix[fix >= 0].astype(np.int64)
    mb, k = fix // 16, fix % 16
    y0 = (mb // mb_w) * 16 + (k // 4) * 4
    x0 = (mb % mb_w) * 16 + (k % 4) * 4
    slot = np.clip(p["ref_slot"].cpu().numpy().reshape(-1)[fix], 0, R - 1)
    mv = p["mv"].cpu().numpy().reshape(-1, 2)[fix].astype(np.int64)
    vx, vy = mv[:, 0], mv[:, 1]
    fullx = np.clip(4 * x0 + vx, (2 - pad) * 4, (W + pad - 19) * 4)
    fully = np.clip(4 * y0 + vy, (2 - pad) * 4, (H + pad - 19) * 4)
    need = k6_luma_need(fullx & 3, fully & 3)
    b, r, c = np.nonzero(need)
    luma = np.zeros(ref_y.shape, bool)
    luma[slot[b], pad + (fully[b] >> 2) - 2 + r,
         pad + (fullx[b] >> 2) - 2 + c] = True
    cfx = np.clip(4 * x0 + vx, (2 - lpad) * 4, (2 * Wc + lpad - 19) * 4)
    cfy = np.clip(4 * y0 + vy, (2 - lpad) * 4, (2 * Hc + lpad - 19) * 4)
    mark_chroma(slot, cpad + (cfy >> 3), cpad + (cfx >> 3), cfy & 7,
                cfx & 7)
    return hp, luma, chroma, len(cr), len(fix)


def k6_bytes_ops(ref_y, ref_u, ref_v, pad, p, mb_w, mb_h):
    """(bytes, operations) K6 must take for the plan `p` on these rings.
    Bytes: every input byte the frame's prediction depends on, once: the
    bucket plane, the fix list and the table (int32 [512] and [32, 16]),
    the samples of k6_reads (U and V alike), each fix-up cell's ref_slot
    and mv; and the three int32 planes written once. Operations: a table
    cell's luma pixel is 3, a chroma one 9; a fix-up cell's luma pixel
    K1_OPS_PER_POSITION (its b, h and j), its chroma pixels 9 each."""
    H, W = 16 * mb_h, 16 * mb_w
    hp, luma, chroma, cells, fix = k6_reads(ref_y, ref_u, pad, p, mb_w,
                                            mb_h)
    per_fix = p["ref_slot"].element_size() + 2 * p["mv"].element_size()
    n_bytes = (16 * mb_w * mb_h + p["mc_fix"].numel() * 4 + 32 * 16 * 4
               + int(hp.sum()) + int(luma.sum()) + 2 * int(chroma.sum())
               + fix * per_fix + 6 * H * W)
    return n_bytes, (cells * (16 * 3 + 2 * 4 * 9)
                     + fix * (16 * K1_OPS_PER_POSITION + 2 * 4 * 9))


def search_mc_phase(data, frames, dev, card):
    """Phase 14: K5 (csrc/me_dense.cu) and K6 (csrc/mc_bucket.cu) against
    their plain versions on the card, torch.equal on every output: K5 on
    the cases of cases.K5_CASES (3 launches each) and on synth720p's frame
    1 against decoded frame 0 (edge-padded, sliced as the encoder slices
    its reference), and refusing radius 23; K6 on cases.K6_CASES (3
    launches each), on every bucketed P frame of synth720p and runs720p
    (the rings their decode gives them), and refusing an entry whose taps
    leave the planes, as the plain version does. Then their times: K5 at
    720p radius 16 on the synth720p pair, K6 per bucketed P frame of
    synth720p (mean): `ms` the wrapper (CUDA events around back-to-back
    calls; K6's includes K1), `kernel_ms` the bare C entry
    (a CUDA graph's replays), `plain_ms` the plain version, beside the
    bound. Returns the K5 and K6 rows of the kernel report."""
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch.cases import (K5_CASES, K6_CASES,
                                              bucketed_mc_frames,
                                              dense_search_case,
                                              random_mc_case)
    from losslessh264_tpu_torch.ops import mc as tmc
    from losslessh264_tpu_torch.ops import me as tme
    lib = _build.lib()

    def flat(triples):
        return [a for t in triples for a in t]

    k5_err = k6_err = 0
    for name, H, W, R, kind, seed, sdy, dtype, strided in K5_CASES:
        cur, ref = dense_search_case(H, W, R, kind, seed, sdy, dtype, strided,
                                     dev)
        want = flat(tme.dense_full_search_plain(cur, ref, R))
        for _ in range(3):
            k5_err = max(k5_err, same(flat(tme.dense_full_search(cur, ref, R)),
                                      want, f"K5 {name}"))
        log(f"K5 dense_full_search == plain: {name}, 3 launches")
    cur = frames[1][0].to(dev).to(torch.int32)
    ref = dt._edge_pad(frames[0][0].to(dev), 32)[16:16 + 752, 16:16 + 1312]
    pair_want = flat(tme.dense_full_search_plain(cur, ref, 16))
    k5_err = max(k5_err, same(flat(tme.dense_full_search(cur, ref, 16)),
                              pair_want, "K5 synth720p frame 1 on frame 0"))
    log("K5 dense_full_search == plain: synth720p frame 1 against frame 0")
    try:
        tme.dense_full_search(cur[:16, :32], ref[:16 + 46, :32 + 46], 23)
        raise SystemExit("K5: radius 23 did not raise")
    except ValueError as e:
        log(f"K5 refuses radius 23: {e}")

    for name, mb_w, mb_h, *rest in K6_CASES:
        case = random_mc_case(mb_w, mb_h, *rest, device=dev)
        want = tmc.mc_bucketed_plain(*case, mb_w, mb_h)
        for _ in range(3):
            k6_err = max(k6_err, same(tmc.mc_bucketed(*case, mb_w, mb_h),
                                      want, f"K6 {name}"))
        p = case[-1]
        log(f"K6 mc_bucketed == plain: {name} (nuniq {p['mc_nuniq']}, "
            f"nslots {p['mc_nslots']}, {int((p['mc_fix'] >= 0).sum())} fix-up "
            f"cells), 3 launches")
    *rings, pad, p = random_mc_case(9, 4, 5, 5, 2, 3, False, device=dev)
    p["mc_uniq"] = p["mc_uniq"].copy()
    p["mc_uniq"][1, 1] = 40
    for fn in (tmc.mc_bucketed, tmc.mc_bucketed_plain):
        try:
            fn(*rings, pad, p, 9, 4)
            raise SystemExit("K6: a window off the planes did not raise")
        except ValueError as e:
            log(f"K6 {fn.__name__} refuses a window off the planes: {e}")
    runs_data = open(RUNS_STREAM, "rb").read()
    for stream, blob in (("runs720p", runs_data), ("synth720p", data)):
        fixes = {}
        for i, *args in bucketed_mc_frames(blob, dev):
            k6_err = max(k6_err, same(tmc.mc_bucketed(*args),
                                      tmc.mc_bucketed_plain(*args),
                                      f"K6 {stream} frame {i}"))
            fixes[i] = int((args[4]["mc_fix"] >= 0).sum())
        log(f"K6 mc_bucketed == plain: every bucketed P frame of {stream}; "
            f"fix-up cells by frame {fixes}")

    # ---- times ----
    n_bytes, n_ops = k5_bytes_ops(720, 1280, 16, 4)
    out = torch.empty((3, 9 * 3600), dtype=torch.int32, device=dev)
    P = ctypes.c_void_p

    def k5_call():
        _build.check(lib.pip_me_dense(
            P(cur.data_ptr()), cur.stride(0), 4, P(ref.data_ptr()),
            ref.stride(0), P(out.data_ptr()), 80, 45, 16,
            _build.stream(dev)), "dense search")
    k5 = {"ms": cuda_ms(lambda: tme.dense_full_search(cur, ref, 16), 20),
          "kernel_ms": kernel_device_ms([k5_call]),
          "plain_ms": cuda_ms(lambda: tme.dense_full_search_plain(
              cur, ref, 16), 3, warmup=1),
          "bytes": n_bytes, "operations": n_ops}
    k5["bound_ms"], k5["bound_by"] = bound_ms(n_bytes, n_ops, INT8_OPS_PER_S)
    k5["int32_rate_ms"] = n_ops / INT32_OPS_PER_S * 1e3
    k5["bound_share"] = k5["bound_ms"] / k5["kernel_ms"]
    if not torch.equal(out.reshape(-1),
                       torch.cat(pair_want[0::3] + pair_want[1::3]
                                 + pair_want[2::3])):
        raise SystemExit("K5's bare entry differs from the plain version")
    log(f"time K5 dense_full_search 720p radius 16 (synth720p frame 1 on "
        f"frame 0, int32 source, strided reference): wrapper "
        f"{k5['ms']:.4f} ms, kernel alone {k5['kernel_ms']:.4f} ms; bound "
        f"{k5['bound_ms']:.5f} ms by {k5['bound_by']} ({n_ops} ops at the "
        f"int8 rate, {n_bytes} bytes), share {k5['bound_share']:.4f}; the "
        f"ops at the int32 lane rate {k5['int32_rate_ms']:.5f} ms; plain "
        f"torch {k5['plain_ms']:.3f} ms on {card}")

    rows = []
    for i, *args in bucketed_mc_frames(data, dev):
        ops_args, preds, keep = tmc.k6_operands(*args)
        p = args[4]
        slots = [int(s) for s in p["mc_slots"][:max(1, p["mc_nslots"])]]

        def k6_call(ops_args=ops_args, keep=(keep, preds)):
            _build.check(lib.pip_mc_bucket(*ops_args, _build.stream(dev)),
                         "bucketed MC")
        nb, no = k6_bytes_ops(*args)
        row = {"frame": i, "nuniq": p["mc_nuniq"],
               "fix_cells": int((p["mc_fix"] >= 0).sum()),
               "ms": cuda_ms(lambda: tmc.mc_bucketed(*args), 10),
               "operands_ms": cuda_ms(lambda: tmc.k6_operands(*args), 10),
               "k1_ms": cuda_ms(lambda: [tmc._halfpel_planes_u8(args[0][s])
                                         for s in slots], 10),
               "kernel_ms": kernel_device_ms([k6_call]),
               "plain_ms": cuda_ms(lambda: tmc.mc_bucketed_plain(*args), 3,
                                   warmup=1),
               "bytes": nb, "operations": no}
        row["bound_ms"], row["bound_by"] = bound_ms(nb, no)
        rows.append(row)
    k6 = {k: sum(r[k] for r in rows) / len(rows)
          for k in ("ms", "operands_ms", "k1_ms", "kernel_ms", "plain_ms",
                    "bytes", "operations", "bound_ms", "fix_cells")}
    k6["bound_by"] = rows[0]["bound_by"]
    k6["bound_share"] = k6["bound_ms"] / k6["kernel_ms"]
    k6["frames"] = len(rows)
    k6["per_frame"] = [{k: (round(v, 5) if isinstance(v, float) else v)
                        for k, v in r.items()} for r in rows]
    log(f"time K6 mc_bucketed, mean of {len(rows)} bucketed P frames of "
        f"synth720p (nuniq {min(r['nuniq'] for r in rows)}.."
        f"{max(r['nuniq'] for r in rows)}, fix-up cells "
        f"{min(r['fix_cells'] for r in rows)}.."
        f"{max(r['fix_cells'] for r in rows)}): wrapper (K1, K6) "
        f"{k6['ms']:.4f} ms = operands {k6['operands_ms']:.4f} (K1 "
        f"{k6['k1_ms']:.4f}, the window checks and the outputs the rest) + "
        f"the launch; kernel alone {k6['kernel_ms']:.5f} ms; bound "
        f"{k6['bound_ms']:.5f} ms by {k6['bound_by']} "
        f"({k6['bytes']:.0f} bytes), share {k6['bound_share']:.3f}; plain "
        f"torch {k6['plain_ms']:.3f} ms on {card}")
    k5["max_abs_err"], k6["max_abs_err"] = k5_err, k6_err
    return k5, k6


def bench_harness():
    """Make bench_port/harness (the benchmark's GOP clips and work counts)
    importable as `harness`."""
    bench = os.path.join(ROOT, "bench_port")
    if bench not in sys.path:
        sys.path.insert(0, bench)


def k11_bytes_ops(ref_y, ref_u, pad, p, mb_w, mb_h):
    """(bytes, operations) K11 must take for the frame's plane dict `p`:
    the benchmark's count (bench_port/harness/workcounts_cells.py: every
    cell's ref_slot, each inter cell's MV and the ring samples its
    quarter-pel and eighth-pel cases read, each sample once, its WP
    triples, and the three int32 planes written once)."""
    bench_harness()
    from harness import workcounts_cells
    return workcounts_cells.k11_bytes_ops(tuple(ref_y.shape),
                                          tuple(ref_u.shape), pad, p, mb_w,
                                          mb_h)


def cells_phase(dev, card):
    """Phase 14, K11 (csrc/mc_cells.cu) beside K6: against its plain
    version (cases.k11_plain) on the card, torch.equal on every output:
    cases.K11_CASES (3 launches each: every MV phase, clipped MVs, every
    ring slot, WP with a partial chroma mask, 640x352 and 720p; each
    case's planes also hold the JAX package's CRC,
    tests/data/k11_jax_crc.json), and every per-cell P frame of runs720p,
    of the walk stand-in's (bench_port/data/walk_analog_1331.264) first
    24 frames and of its GOP at frame 200 (the scene cut at 280), each
    GOP decoded alone (harness/gops.py; the rings their decode gives
    them). Then its times per per-cell P frame of the walk stand-in's
    first 24 frames (mean): `ms` the wrapper (CUDA events around
    back-to-back calls), `kernel_ms` the bare C entry (a CUDA graph's
    replays), `plain_ms` the torch chain it replaces (_mc_legacy_cells
    and _tiles_to_plane, the route's plain path), beside the bound.
    Returns the K11 row of the kernel report."""
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch.cases import (K11_CASES, cells_mc_frames,
                                              k11_plain, random_cells_case)
    from losslessh264_tpu_torch.ops import mc as tmc
    bench_harness()
    from harness import gops, streams
    lib = _build.lib()
    with open(os.path.join(ROOT, "tests", "data", "k11_jax_crc.json")) as fh:
        jax_crc = json.load(fh)["crc32"]
    err = 0
    for name, mb_w, mb_h, seed, kw in K11_CASES:
        *rings, pad, p = random_cells_case(mb_w, mb_h, seed, device=dev,
                                           **kw)
        want = k11_plain(*rings, pad, p, mb_w, mb_h)
        for _ in range(3):
            got = tmc.mc_cells(*rings, pad, p, mb_w, mb_h)
            err = max(err, same(got, want, f"K11 {name}"))
        crc = zlib.crc32(b"".join(g.cpu().numpy().tobytes() for g in got))
        if crc != jax_crc[name]:
            raise SystemExit(f"K11 {name}: CRC {crc}, the JAX package's "
                             f"{jax_crc[name]}")
        log(f"K11 mc_cells == plain and the JAX package's CRC: {name}, 3 "
            f"launches")

    def route_frames(blob):
        for i, mb_w, mb_h, p, *rings in cells_mc_frames(blob, dev):
            yield i, (*rings, dt.PAD, p, mb_w, mb_h)

    with open(RUNS_STREAM, "rb") as fh:
        runs_data = fh.read()
    with open(WALK_STREAM, "rb") as fh:
        walk_data = fh.read()
    offsets = streams.access_unit_offsets(walk_data)
    walk = gops.gop_clip(walk_data, 0, 24, offsets)
    for stream, blob in (("runs720p", runs_data), ("walk 0-23", walk),
                         ("walk 200-299",
                          gops.gop_clip(walk_data, 200, 300, offsets))):
        seen = []
        for i, args in route_frames(blob):
            err = max(err, same(tmc.mc_cells(*args), k11_plain(*args),
                                f"K11 {stream} frame {i}"))
            seen.append(i)
        if not seen:
            raise SystemExit(f"K11: no frame of {stream} took the per-cell "
                             "route")
        log(f"K11 mc_cells == plain: every per-cell P frame of {stream} "
            f"({len(seen)} frames)")

    # ---- times ----
    rows = []
    for i, args in route_frames(walk):
        rings, pad, p, mb_w, mb_h = args[:3], *args[3:]
        ops_args, preds, keep = tmc.k11_operands(*args)

        def k11_call(ops_args=ops_args, keep=(keep, preds)):
            _build.check(lib.pip_mc_cells(*ops_args, _build.stream(dev)),
                         "per-cell MC")

        def chain(rings=rings, p=p, mb_w=mb_w, mb_h=mb_h):
            tiles = dt._mc_legacy_cells(mb_w, mb_h, p, *rings)
            return [dt._tiles_to_plane(t, mb_w, mb_h, s)
                    for t, s in zip(tiles, (16, 8, 8))]
        nb, no = k11_bytes_ops(rings[0], rings[1], pad, p, mb_w, mb_h)
        row = {"frame": i,
               "inter_cells": int((p["ref_slot"] >= 0).sum()),
               "ms": cuda_ms(lambda: tmc.mc_cells(*args), 10),
               "kernel_ms": kernel_device_ms([k11_call]),
               "plain_ms": cuda_ms(chain, 5, warmup=1),
               "bytes": nb, "operations": no}
        row["bound_ms"], row["bound_by"] = bound_ms(nb, no)
        rows.append(row)
    k11 = {k: sum(r[k] for r in rows) / len(rows)
           for k in ("ms", "kernel_ms", "plain_ms", "bytes", "operations",
                     "bound_ms", "inter_cells")}
    k11["bound_by"] = rows[0]["bound_by"]
    k11["bound_share"] = k11["bound_ms"] / k11["kernel_ms"]
    k11["frames"] = len(rows)
    k11["per_frame"] = [{k: (round(v, 5) if isinstance(v, float) else v)
                         for k, v in r.items()} for r in rows]
    k11["max_abs_err"] = err
    log(f"time K11 mc_cells, mean of {len(rows)} per-cell P frames of "
        f"the walk stand-in (640x352, {k11['inter_cells']:.0f} inter "
        f"cells): wrapper {k11['ms']:.4f} ms; kernel alone "
        f"{k11['kernel_ms']:.5f} ms; bound {k11['bound_ms']:.5f} ms by "
        f"{k11['bound_by']} ({k11['bytes']:.0f} bytes), share "
        f"{k11['bound_share']:.3f}; the torch chain it replaces "
        f"{k11['plain_ms']:.3f} ms on {card}")
    return k11


# integer operations per output sample (estimates from the kernels' code,
# for the bound): K7 ~16 (a sample's dequant, its share of the inverse
# transform's butterflies, the rounding shift, the add of the prediction
# and the clamps); K8 ~40 (the residual, the forward and inverse
# transforms, the quantizer with its trellis test, the dequant, the
# recon, and chroma's bilinear prediction)
K7_OPS_PER_SAMPLE = 16
K8_OPS_PER_SAMPLE = 40


def k7_bytes_ops(mb_w, mb_h, p, pred_y):
    """(bytes, operations) K7 must take for the frame `p`: every input
    byte its outputs depend on, once: the five per-MB bytes and the
    ref_slot row of every MB; the levels of the blocks each MB's path
    reads (on the 4x4 path a coded 4x4 block's 32 bytes of luma_ac, an
    I16 MB's 16 blocks and its 32 bytes of luma_dc; a coded 8x8 block's
    128 bytes of luma8; chroma_dc's 16 bytes where cbp_chroma != 0 and
    the 8 chroma_ac blocks where it is 2); the int32 prediction of the
    inter MBs that are not PCM (384 samples each), a PCM MB's 384 bytes
    and, with use_scaling, the weight matrices; and the padded int32
    planes and the residual tiles written once. Operations:
    K7_OPS_PER_SAMPLE for each of an MB's 384 samples."""
    n = mb_w * mb_h
    H, W = 16 * mb_h, 16 * mb_w
    g = {k: p[k].cpu().numpy().astype(np.int64) for k in (
        "mb_class", "cbp_luma", "cbp_chroma", "transform8", "ref_slot")}
    cls, cbp, cbpc = g["mb_class"], g["cbp_luma"], g["cbp_chroma"]
    i16 = cls == 1
    t8 = (g["transform8"] != 0) & ~i16
    coded8 = sum((cbp >> b) & 1 for b in range(4))
    luma = np.where(t8, coded8 * (128 if "luma8" in p else 0),
                    np.where(i16, 16 * 32 + 32, coded8 * 4 * 32))
    chroma = (cbpc != 0) * 16 + (cbpc == 2) * 8 * 32
    pcm = (cls == 8) & ("pcm" in p)
    inter = (g["ref_slot"] >= 0).all(1) & ~pcm & (pred_y is not None)
    n_bytes = (n * (5 + 64) + int(luma.sum()) + int(chroma.sum())
               + int(inter.sum()) * 384 * 4 + int(pcm.sum()) * 384
               + (6 * 64 + 2 * 256 if p["use_scaling"] else 0)
               + 4 * ((H + 16) * (W + 16) + 2 * (H // 2 + 16) * (W // 2 + 16))
               + 4 * 384 * n)
    return n_bytes, K7_OPS_PER_SAMPLE * 384 * n


def k8_bytes_ops(mb_w, mb_h, args):
    """(bytes, operations) K8 must take for inter_residual's arguments
    `args`: the source planes (in their dtype), pred_q, the quadrants'
    MVs and the per-MB SAD, partition, x offset, qp and qpc, once; the
    chroma reference samples the quadrants' bilinear windows weigh by
    more than 0 (the right column only if fx > 0, the lower row only if
    fy > 0; the window clamped as the kernel clamps it), each once, U and
    V alike; the outputs written once (use_intra and no_res a byte each,
    the rest int32). Operations: K8_OPS_PER_SAMPLE for each of an MB's
    384 samples."""
    Y, U, V, pred_q, mvqx, mvqy = args[:6]
    refU, xoffC = args[8], args[10]
    n = mb_w * mb_h
    Hc, Wc = refU.shape
    mx, my, xo = (a.cpu().numpy().astype(np.int64)
                  for a in (mvqx, mvqy, xoffC))
    quad, mbi = np.arange(4), np.arange(n)
    cy = (((mbi // mb_w) * 8)[:, None] + (quad // 2) * 4).reshape(-1)
    cx = (((mbi % mb_w) * 8 + xo)[:, None] + (quad % 2) * 4).reshape(-1)
    iy = np.clip(16 + cy + (my >> 3), 0, Hc - 5)
    ix = np.clip(16 + cx + (mx >> 3), 0, Wc - 5)
    o = np.arange(5)
    keep = ((o[None, :, None] < 4 + ((my & 7) > 0)[:, None, None])
            & (o[None, None, :] < 4 + ((mx & 7) > 0)[:, None, None]))
    ys = np.broadcast_to(iy[:, None, None] + o[None, :, None], keep.shape)
    xs = np.broadcast_to(ix[:, None, None] + o[None, None, :], keep.shape)
    mask = np.zeros((Hc, Wc), bool)
    mask[ys[keep], xs[keep]] = True
    n_bytes = ((Y.numel() + U.numel() + V.numel()) * Y.element_size()
               + 4 * (pred_q.numel() + 8 * n + 5 * n) + 2 * int(mask.sum())
               + n * (2 + 4 * (1 + 8 + 256 + 8 + 128 + 256 + 128)))
    return n_bytes, K8_OPS_PER_SAMPLE * 384 * n


def clone_args(args):
    """A copy of a call's arguments: tensors cloned, a plane dict's
    tensors (and lists of them) cloned, the rest as they are."""
    def c(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, dict):
            return {k: c(v) for k, v in a.items()}
        if isinstance(a, list):
            return [c(v) for v in a]
        return a
    return tuple(c(a) for a in args)


def cold_calls(entry, operands, args, n_bytes, cold_bytes=100e6):
    """No-argument calls of the bare C entry `entry` on enough copies of
    the arguments `args` (made into the entry's operands by `operands`,
    each copy with its own outputs) that one turn through them moves more
    than `cold_bytes`, twice the H100's 50 MB L2: every launch finds its
    inputs out of L2, as the frame's own launch does."""
    from losslessh264_tpu_torch import _build
    calls = []
    for _ in range(int(min(16, max(2, -(-cold_bytes // n_bytes))))):
        ops, outs, keep = operands(*clone_args(args))
        dev = outs[0].device

        def run(ops=ops, keep=(ops, outs, keep), dev=dev):
            _build.check(entry(*ops, _build.stream(dev)), entry.__name__)
        calls.append(run)
    return calls


def residual_phase(data, frames, dev, card):
    """Phase 15: K7 (csrc/residual_dec.cu) and K8 (csrc/residual_enc.cu)
    against their plain versions on the card, exact (dtype and
    torch.equal of every output): K7 on cases.K7_CASES (3 launches each)
    and on every frame of a decode of synth720p and of runs720p (the
    decode's own calls held to the plain version on the same arguments,
    cases.HeldToPlain; the CRCs must hold); K8 on cases.K8_CASES (3
    launches each) and on every P frame of the encodes of A-E and G (the
    same, over encodes that must reproduce the goldens' SHA-256). Then
    their times: K7 per frame of synth720p (the means over its P frames,
    the frames with a prediction, and over its IDR), K8 per P frame of A
    (frames 1-3):
    `ms` the wrapper (CUDA events around back-to-back calls), `kernel_ms`
    the bare C entry (a CUDA graph's replays over copies of the operands
    that move more than 100 MB a turn, so that every launch finds its
    inputs out of L2), `plain_ms` the plain version, beside the bound.
    K9's wrapper is held to its plain version the same way on every call
    of those decodes and encodes, and must launch just where K2 does.
    Returns the K7 and K8 rows of the kernel report, K9's largest
    difference from its plain version and the arguments of its calls in
    the synth720p decode and in encode A."""
    import hashlib
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import encoder_torch as et
    from losslessh264_tpu_torch.cases import (K7_CASES, K8_CASES, HeldToPlain,
                                              golden_encoder,
                                              inter_residual_args,
                                              random_inter_residual_case,
                                              random_residual_case,
                                              residual_frames)
    from losslessh264_tpu_torch.ops import deblock as tdb
    lib = _build.lib()
    k9_err, k9_kept = 0, {}

    def held_k9(keep=0):
        """K9's wrapper held to its plain version beside K7 or K8."""
        return HeldToPlain(tdb, "edge_params_packed",
                           tdb.edge_params_packed_plain, keep=keep)

    def check_k9(held9, what):
        """K9 must have launched just where K2 did, each call equal to the
        plain version; returns its largest difference (0)."""
        k2, k9 = launches_now()[1], launches_now()[8]
        if held9.bad or not held9.calls == k9 == k2 > 0:
            raise SystemExit(f"K9 on {what}: {held9.calls} calls, {k9} "
                             f"launches, K2 {k2}; calls {held9.bad} differ "
                             f"from the plain version (max abs err "
                             f"{held9.max_abs_err})")
        log(f"K9 edge_params_packed == plain: every deblocked frame of "
            f"{what} ({held9.calls}, all 384 lanes), launched where K2 was")
        return held9.max_abs_err

    # ---- K7 ----
    k7_err = 0
    for name, mb_w, mb_h, seed, kw in K7_CASES:
        planes, *rings = random_residual_case(mb_w, mb_h, seed, **kw)
        p = dt.planes_to_torch(planes, dev)
        pred = dt._inter_pred(mb_w, mb_h, p, *(torch.as_tensor(
            r, device=dev) for r in rings)) or (None,) * 3
        want = dt._residual_recon_plain(mb_w, mb_h, p, *pred)
        for _ in range(3):
            got = dt._residual_recon(mb_w, mb_h, p, *pred)
            k7_err = max(k7_err, same(got, want, f"K7 {name}"))
        log(f"K7 residual_recon == plain: {name}, 3 launches")
    for stream, blob, gold in (
            ("synth720p", data, json.load(open(GOLDEN))["synth720p"]),
            ("runs720p", open(RUNS_STREAM, "rb").read(),
             json.load(open(RUNS_GOLDEN))["runs720p"])):
        reset_launches()
        with HeldToPlain(dt, "_residual_recon",
                         dt._residual_recon_plain) as held, held_k9(
                keep=25 if stream == "synth720p" else 0) as held9:
            crcs = [zlib.crc32(b"".join(a.cpu().numpy().tobytes()
                                        for a in yuv))
                    for yuv in dt.TorchDecoder(blob, device=dev).frames()]
        crcs_hold = crcs == gold["crc32"]
        if not crcs_hold or held.bad or held.calls != len(crcs):
            raise SystemExit(f"K7 on {stream}: {held.calls} calls, frames "
                             f"{held.bad} differ from the plain version (max "
                             f"abs err {held.max_abs_err}); CRCs "
                             f"{'hold' if crcs_hold else 'differ'}")
        k7_err = max(k7_err, held.max_abs_err)
        log(f"K7 residual_recon == plain: every frame of {stream} "
            f"({held.calls}), its CRCs hold")
        k9_err = max(k9_err, check_k9(held9, f"the {stream} decode"))
        if stream == "synth720p":
            k9_kept["decode"] = held9.kept

    # ---- K8 ----
    k8_err = 0
    for name, mb_w, mb_h, seed, R, qp, rd_lam in K8_CASES:
        args = inter_residual_args(random_inter_residual_case(
            mb_w, mb_h, seed, R, qp, rd_lam, dev))
        want = et.inter_residual_plain(mb_w, mb_h, *args)
        for _ in range(3):
            got = et.inter_residual(mb_w, mb_h, *args)
            k8_err = max(k8_err, same(got, want, f"K8 {name}"))
        log(f"K8 inter_residual == plain: {name}, 3 launches")
    configs = []
    for path, names in ((ENC_GOLDEN, "AB"), (ENC_GOLDEN_CDE, "CDE"),
                        (ENC_GOLDEN_G, "G")):
        gold = json.load(open(path))
        configs += [(name, gold[name]) for name in names]
    W, H = gold["source"]["width"], gold["source"]["height"]
    src = [tuple(np.ascontiguousarray(p.numpy()) for p in f)
           for f in frames[:max(len(c["frames"]) for _, c in configs)]]
    a_args = None
    for name, cfg in configs:
        enc = golden_encoder(cfg, W, H, dev)
        reset_launches()
        with HeldToPlain(et, "inter_residual", et.inter_residual_plain,
                         keep=3 if name == "A" else 0) as held, held_k9(
                             keep=4 if name == "A" else 0) as held9:
            n_frames = len(cfg["frames"])
            if name == "G":
                out = enc.encode_frames(src[:n_frames], batch=cfg["batch"])
            else:
                out = []
                for i, f in enumerate(src[:n_frames]):
                    for call in cfg.get("calls", {}).get(str(i), ()):
                        getattr(enc, call)()
                    out.append(enc.encode_frame_layers(*f)
                               if "simulcast" in cfg else enc.encode_frame(*f))
        k1 = launches_now()[0]
        shas = [[hashlib.sha256(d).hexdigest() for d in (
            o if isinstance(o, list) else [o])] for o in out]
        gold_shas = [[gl["sha256"] for gl in g.get("layers", [g])]
                     for g in cfg["frames"]]
        if shas != gold_shas or held.bad or held.calls != k1 or k1 == 0:
            raise SystemExit(f"K8 on encode {name}: {held.calls} calls ({k1} "
                             f"K1 launches), calls {held.bad} differ from the "
                             f"plain version (max abs err "
                             f"{held.max_abs_err}); SHA-256 "
                             f"{'hold' if shas == gold_shas else 'differ'}")
        k8_err = max(k8_err, held.max_abs_err)
        if name == "A":
            a_args = held.kept
            k9_kept["encode A"] = held9.kept
        log(f"K8 inter_residual == plain: every P frame of encode {name} "
            f"({held.calls}), its SHA-256 hold")
        k9_err = max(k9_err, check_k9(held9, f"encode {name}"))

    # ---- times ----
    def k7_row(mb_w, mb_h, p, *pred):
        nb, no = k7_bytes_ops(mb_w, mb_h, p, pred[0])
        args = (mb_w, mb_h, p, *pred)
        row = {"ms": cuda_ms(lambda: dt._residual_recon(*args), 10),
               "kernel_ms": kernel_device_ms(cold_calls(
                   lib.pip_residual_dec, dt.k7_operands, args, nb)),
               "plain_ms": cuda_ms(lambda: dt._residual_recon_plain(*args),
                                   3, warmup=1),
               "bytes": nb, "operations": no}
        row["bound_ms"], row["bound_by"] = bound_ms(nb, no)
        return row

    rows = []
    for i, mb_w, mb_h, p, *pred in residual_frames(data, dev):
        row = k7_row(mb_w, mb_h, p, *pred)
        row["frame"], row["inter"] = i, pred[0] is not None
        rows.append(row)
    keys = ("ms", "kernel_ms", "plain_ms", "bytes", "operations", "bound_ms")
    inter = [r for r in rows if r["inter"]]
    intra = [r for r in rows if not r["inter"]]
    k7 = {k: sum(r[k] for r in inter) / len(inter) for k in keys}
    k7["bound_by"] = inter[0]["bound_by"]
    k7["bound_share"] = k7["bound_ms"] / k7["kernel_ms"]
    k7["frames"] = len(inter)
    k7["intra_frames"] = {k: sum(r[k] for r in intra) / len(intra)
                          for k in keys}
    k7["per_frame"] = [{k: (round(v, 5) if isinstance(v, float) else v)
                        for k, v in r.items()} for r in rows]
    log(f"time K7 residual_recon, mean of the {len(inter)} P frames of "
        f"synth720p: wrapper {k7['ms']:.4f} ms, kernel alone "
        f"{k7['kernel_ms']:.5f} ms; bound {k7['bound_ms']:.5f} ms by "
        f"{k7['bound_by']} ({k7['bytes']:.0f} bytes), share "
        f"{k7['bound_share']:.3f}; plain torch {k7['plain_ms']:.3f} ms; "
        f"its {len(intra)} intra frames: kernel "
        f"{k7['intra_frames']['kernel_ms']:.5f} ms, bound "
        f"{k7['intra_frames']['bound_ms']:.5f} ms, plain "
        f"{k7['intra_frames']['plain_ms']:.3f} ms on {card}")

    rows = []
    for args in a_args:
        nb, no = k8_bytes_ops(args[0], args[1], args[2:])
        row = {"ms": cuda_ms(lambda: et.inter_residual(*args), 10),
               "kernel_ms": kernel_device_ms(cold_calls(
                   lib.pip_residual_enc, et.k8_operands, args, nb)),
               "plain_ms": cuda_ms(lambda: et.inter_residual_plain(*args), 3,
                                   warmup=1),
               "bytes": nb, "operations": no}
        row["bound_ms"], row["bound_by"] = bound_ms(nb, no)
        rows.append(row)
    k8 = {k: sum(r[k] for r in rows) / len(rows) for k in keys}
    k8["bound_by"] = rows[0]["bound_by"]
    k8["bound_share"] = k8["bound_ms"] / k8["kernel_ms"]
    k8["frames"] = len(rows)
    log(f"time K8 inter_residual, mean of A's P frames 1-{len(rows)}: "
        f"wrapper {k8['ms']:.4f} ms, kernel alone {k8['kernel_ms']:.5f} ms; "
        f"bound {k8['bound_ms']:.5f} ms by {k8['bound_by']} "
        f"({k8['bytes']:.0f} bytes), share {k8['bound_share']:.3f}; plain "
        f"torch {k8['plain_ms']:.3f} ms on {card}")
    k7["max_abs_err"], k8["max_abs_err"] = k7_err, k8_err
    return k7, k8, k9_err, k9_kept


# integer operations K9's function needs per MB (an estimate, for the
# bound): the bS of its 32 distinct cell edges (~20 each: the class,
# nnz, ref and MV tests, the slice, idc and transform-8x8 masks), a table
# lookup for each of the 160 tc0 lanes (~4) and the 24 alpha / beta lanes
# with their QP averages and clamps (~8)
K9_OPS_PER_MB = 32 * 20 + 160 * 4 + 24 * 8


def k9_bytes_ops(mb_w, mb_h, args):
    """(bytes, operations) K9 must take for edge_params_packed's arguments
    `args` (after mb_w, mb_h): each plane's distinct elements read once in
    their own dtype (an expanded view's once), the table operand, and the
    [n, 384] int32 rows written once. Operations: K9_OPS_PER_MB per MB."""
    from losslessh264_tpu_torch.ops import deblock as tdb
    n = mb_w * mb_h
    n_bytes = tdb._K9_TABLES.nbytes + 4 * n * tdb.PACK_WIDTH
    for a in args[:10]:
        if torch.is_tensor(a):
            distinct = 1
            for size, stride in zip(a.shape, a.stride()):
                distinct *= size if stride else 1
            n_bytes += distinct * a.element_size()
    return n_bytes, K9_OPS_PER_MB * n


def edge_params_phase(k9_err, k9_kept, dev, card):
    """Phase 16: K9 (csrc/deblock_params.cu) against its plain version on
    the card on cases.K9_CASES, exact (dtype and torch.equal of all 384
    lanes; 3 launches each; phase 15 held it on every call of its decodes
    and encodes). Its times per frame of synth720p (the decoder's planes)
    and of encode A (the encoder's int32 and absent planes), from the
    arguments phase 15 kept: `ms` the wrapper (CUDA events around
    back-to-back calls), `kernel_ms` the bare C entry (a CUDA graph's
    replays over copies of the operands that move more than 100 MB a
    turn: cold L2), `plain_ms` the plain version, beside the bound.
    Returns K9's row of the kernel report."""
    from losslessh264_tpu_torch import _build
    from losslessh264_tpu_torch.cases import K9_CASES, random_edge_case
    from losslessh264_tpu_torch.ops import deblock as tdb
    lib = _build.lib()
    for name, mb_w, mb_h, seed, kw in K9_CASES:
        case = random_edge_case(mb_w, mb_h, seed, dev, **kw)
        want = tdb.edge_params_packed_plain(mb_w, mb_h, *case)
        for _ in range(3):
            got = tdb.edge_params_packed(mb_w, mb_h, *case)
            k9_err = max(k9_err, same((got,), (want,), f"K9 {name}"))
        log(f"K9 edge_params_packed == plain: {name}, 3 launches")

    keys = ("ms", "kernel_ms", "plain_ms", "bytes", "operations",
            "bound_ms")
    rows = {}
    for what, kept in k9_kept.items():
        rows[what] = []
        for args in kept:
            nb, no = k9_bytes_ops(args[0], args[1], args[2:])
            row = {"ms": cuda_ms(lambda: tdb.edge_params_packed(*args), 20),
                   "kernel_ms": kernel_device_ms(cold_calls(
                       lib.pip_deblock_params, tdb.k9_operands, args, nb)),
                   "plain_ms": cuda_ms(
                       lambda: tdb.edge_params_packed_plain(*args), 3,
                       warmup=1),
                   "bytes": nb, "operations": no}
            row["bound_ms"], row["bound_by"] = bound_ms(nb, no)
            rows[what].append(row)
    mean = {what: {k: sum(r[k] for r in rs) / len(rs) for k in keys}
            for what, rs in rows.items()}
    k9 = dict(mean["decode"])
    k9["bound_by"] = rows["decode"][0]["bound_by"]
    k9["bound_share"] = k9["bound_ms"] / k9["kernel_ms"]
    k9["frames"] = len(rows["decode"])
    k9["encode_a"] = dict(mean["encode A"], frames=len(rows["encode A"]),
                          bound_by=rows["encode A"][0]["bound_by"])
    k9["max_abs_err"] = k9_err
    label = {"decode": "the synth720p decode", "encode A": "encode A"}
    for what, m in mean.items():
        log(f"time K9 edge_params_packed, mean of the {len(rows[what])} "
            f"deblocked frames of {label[what]}: "
            f"wrapper {m['ms']:.4f} ms, kernel alone "
            f"{m['kernel_ms']:.5f} ms; "
            f"bound {m['bound_ms']:.5f} ms by {rows[what][0]['bound_by']} "
            f"({m['bytes']:.0f} bytes), share "
            f"{m['bound_ms'] / m['kernel_ms']:.3f}; plain torch "
            f"{m['plain_ms']:.3f} ms on {card}")
    return k9


def profile_report(prof, wall_ms, what, card):
    """Wall time against the summed device time of every kernel and copy
    of one torch.profiler window, and the kernels that take the most."""
    # device-side events only (kernels, memcpy): a CPU op's own device
    # total repeats its kernels' time
    evs = [(e.self_device_time_total / 1e3, e.count, e.key)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e[0] for e in evs)
    log(f"profile {what}: wall {wall_ms:.3f} ms, summed device time "
        f"{busy_ms:.3f} ms, device busy share {busy_ms / wall_ms:.4f} on "
        f"{card}")
    for ms, count, key in sorted(evs, reverse=True)[:6]:
        log(f"  profile {ms:.3f} ms x{count} {key[:90]}")


def profile_windows(data, device, card, enc_src):
    """torch.profiler over two windows of one decode, P frames 1-3 (the
    steady state of the stream) and frame 10 (3374 of 3600 MBs intra),
    and over the P frames 1-3 of encode configuration A (`enc_src`: its
    four source frames; the IDR is encoded outside the window)."""
    from torch.profiler import ProfilerActivity, profile
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import encoder_torch as et
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    frames = dt.TorchDecoder(data, device=device).frames()
    done = 0
    for first, last in ((1, 3), (10, 10)):
        while done < first:           # decoded outside the window
            next(frames)
            done += 1
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            while done <= last:
                next(frames)
                done += 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        profile_report(prof, wall_ms, f"decode frames {first}-{last}", card)
    gold = json.load(open(ENC_GOLDEN))
    enc = et.TorchEncoder(gold["source"]["width"], gold["source"]["height"],
                          device=device, **gold["A"]["kwargs"])
    enc.encode_frame(*enc_src[0])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in enc_src[1:4]:
            enc.encode_frame(*f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile_report(prof, wall_ms, "encode A P frames 1-3", card)


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
        ("random 784x2688 (encoder, refs=2)", rand_plane(784, 2688)),
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
    syms = list(native.SymbolDecoder(data))
    deblocked = sum(bool(dt.TorchDecoder._needs_deblock(
        f, dt.TorchDecoder._nnz_plane(f))) for f in syms)
    # frames with intra MBs: one K3 launch each (no run of all-intra
    # frames in this stream, so no batch)
    intra_frames = sum(bool(np.isin(f["mb_class"], [0, 1, 2]).any())
                       for f in syms)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = dt.TorchDecoder(data, device=dev)
    frames = [tuple(a.cpu() for a in yuv) for yuv in dec.frames()]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec_launches = launches_now()
    (k1_launches, k2_launches, k3_launches, _, _, k6_launches, k7_launches,
     _, k9_launches, _) = dec_launches
    # a second decode under a sync=True recording: each frame's stages,
    # and the MC routes the plans took, which imply the first one's K1,
    # K6 and K11 launches (K6 once per bucketed P frame, K1 once per ring
    # slot such a frame reads, K11 once per P frame on the per-cell route)
    stage_rows, rec = recorded_decode(data, dev)
    bucketed = rec.counters.get("dec.mc_bucketed", 0)
    per_cell = rec.counters.get("dec.mc_cells", 0)
    k1_implied = rec.counters.get("dec.mc_slots", 0)
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
    log(f"launches during decode: {launch_str(dec_launches)} for "
        f"{deblocked} deblocked frames, {intra_frames} frames with intra "
        f"MBs, {bucketed} bucketed P frames (K1 {k1_implied} implied) and "
        f"{per_cell} per-cell P frames; routes {dec.routes}")
    if min(k1_launches, k2_launches, k3_launches, k6_launches,
           k7_launches, k9_launches) <= 0:
        raise SystemExit("a kernel of the decode path was never launched")
    # K7 once per frame, K9 before every K2
    want = (k1_implied, deblocked, intra_frames, 0, 0, bucketed, len(frames),
            0, deblocked, per_cell)
    if dec_launches != want or per_cell == 0:
        raise SystemExit(f"K1-K11 launched {dec_launches} times, the frames "
                         f"imply {want}")

    # ---- 6. encode on the card ----
    enc_launches, enc_frames, c_idr_qp = encode_phase(frames, dev, card)

    # ---- 7-10. the older encoder, GOP-parallel decode, the CLI's
    # recompression verbs, the graft dryrun: each path's counts are set
    # to 0 just before it and read just after (inside each phase)
    path_launches = {
        "older_encode": older_encode_phase(frames, dev, card),
        "gop_parallel_decode": gop_parallel_phase(
            data, golden, dec_launches, dev, card),
    }
    cli_phase(card)
    path_launches["graft_ranks"] = graft_phase(dev, card)

    # ---- 11-12. the all-intra batch, the sparse intra pass, the encoder's
    # P runs: counts set to 0 just before each main run, read just after
    path_launches["runs_decode"] = runs_decode_phase(dev, card)
    path_launches["encode_runs"] = encode_runs_phase(frames, dev, card)

    # ---- 13. K3 and K4 against their plain versions, and their times ----
    k3, k4 = intra_kernels_phase(data, frames, c_idr_qp, dev, card)

    # ---- 14. K5 and K6 against their plain versions, and their times ----
    k5, k6 = search_mc_phase(data, frames, dev, card)
    k11 = cells_phase(dev, card)

    # ---- 15. K7 and K8 against their plain versions, and their times; K9
    # held to its plain version on the same decodes and encodes ----
    k7, k8, k9_err, k9_kept = residual_phase(data, frames, dev, card)

    # ---- 16. K9 against its plain version on its cases, and its times ----
    k9 = edge_params_phase(k9_err, k9_kept, dev, card)

    # ---- 17. times ----
    # K1 at each size, both entries: `ms` the wrapper by CUDA events over
    # back-to-back calls, `kernel_ms` the bare C entry's kernel alone (a
    # CUDA graph's replays, cold L2), beside the bound, the plain version
    # and the conv2d yardstick. 720p is the decode path's reference plane
    # (frame 0 of synth720p, padded), the others random planes.
    k1_sizes = {}
    k1_planes = dict(zip(K1_SIZES, (x for _, x in k1_inputs[1:5])))
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
    # wrapper on packed rows, as the main path calls it after K9 (int32
    # copies of the planes, the launch);
    # `kernel_ms` the bare C entry on packed rows, each timed launch on
    # its own fresh copy of the planes
    (Yw, Uw, Vw), _, params = random_deblock_case(80, 45, 0, dev)
    P = tdb._pack_params(params).contiguous()
    k2_ms = cuda_ms(lambda: tdb.deblock_wavefront(80, 45, Yw, Uw, Vw, P),
                    20)
    k2_kernel_ms = cuda_ms_each([
        k2_launcher(_build.lib(), 80, 45, [a.clone() for a in (Yw, Uw, Vw)],
                    P, dev) for _ in range(22)])
    k2_plain_ms = cuda_ms(lambda: tdb.deblock_wavefront_plain(
        80, 45, Yw, Uw, Vw, params), 3, warmup=1)
    # ~40 int32 ops per luma line of an edge (16 lines x 8 edges per MB)
    # and ~20 per chroma line (8 lines x 4 edges x 2 planes)
    k2_b = k2_bytes(80, 45)
    k2_bound, k2_by = bound_ms(k2_b, 80 * 45 * (128 * 40 + 64 * 20))
    log(f"time K2 deblock 80x45 MBs per frame: wrapper on packed rows "
        f"(copies, kernel) {k2_ms:.4f} ms, kernel alone "
        f"{k2_kernel_ms:.4f} ms = "
        f"{k2_kernel_ms * 1e3 / (2 * 44 + 80):.3f} us per step of the "
        f"{2 * 44 + 80}-MB chain; bound {k2_bound:.4f} ms by {k2_by} "
        f"({k2_b} bytes); plain torch {k2_plain_ms:.4f} ms on {card}")
    rows = stage_rows
    for r in rows:
        log("stage " + json.dumps({k: (round(v, 3) if isinstance(v, float)
                                       else v) for k, v in r.items()}))
    for key in ("host_ms", "mc_ms", "residual_recon_ms", "intra_ms",
                "edge_params_ms", "k2_ms", "crop_ms", "store_ms"):
        log(f"stage total {key}: {sum(r[key] for r in rows):.3f} ms over "
            f"{len(rows)} frames on {card}")
    k1 = k1_sizes["720p"]
    all_paths = {"decode": dict(zip(KERNELS, dec_launches)),
                 "encode": enc_launches, **path_launches}
    profile_windows(data, dev, card,
                    [tuple(p.numpy() for p in f) for f in frames[:4]])

    log(json.dumps({"kernels": [
        {"name": "halfpel_planes", "route": "cuda",
         "source": "losslessh264_tpu_torch/csrc/halfpel.cu",
         "replaces": "losslessh264_tpu/ops/mc.py:144",
         "launches": k1_launches + enc_launches["K1"] + sum(
             v["K1"] for v in path_launches.values()),
         "launches_per_decode": k1_launches,
         "launches_per_encode": enc_launches["K1"],
         **{f"launches_per_{k}": v["K1"] for k, v in path_launches.items()},
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
         "launches": k2_launches + enc_launches["K2"] + sum(
             v["K2"] for v in path_launches.values()),
         "launches_per_decode": k2_launches,
         "launches_per_encode": enc_launches["K2"],
         **{f"launches_per_{k}": v["K2"] for k, v in path_launches.items()},
         "max_abs_err": k2_err, "ms": k2_ms, "kernel_ms": k2_kernel_ms,
         "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        *({"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "replaces_also": also,
           "launches": sum(v[key] for v in all_paths.values()),
           **{f"launches_per_{k}": v[key] for k, v in all_paths.items()},
           "max_abs_err": row["max_abs_err"], "ms": row["ms"],
           "kernel_ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
           "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
           "chain_steps": row["chain_steps"], "library_ms": None,
           **{k: row[k] for k in ("bytes", "byte_bound_ms", "per_frame",
                                  "c_idr_ms", "row_80x1_ms",
                                  "row_80x1_us_per_mb", "column_1x45_ms",
                                  "column_1x45_us_per_mb") if k in row}}
          for name, source, replaces, also, key, row in (
              ("intra_recon", "losslessh264_tpu_torch/csrc/intra_dec.cu",
               "losslessh264_tpu/decoder_jax.py:420",
               ["losslessh264_tpu/decoder_jax.py:594",
                "losslessh264_tpu/decoder_jax.py:702"], "K3", k3),
              ("intra_wavefront", "losslessh264_tpu_torch/csrc/intra_enc.cu",
               "losslessh264_tpu/encoder_jax.py:281", [], "K4", k4))),
        *({"name": name, "route": "cuda", "source": source,
           "replaces": replaces,
           "launches": sum(v[key] for v in all_paths.values()),
           **{f"launches_per_{k}": v[key] for k, v in all_paths.items()},
           "max_abs_err": row["max_abs_err"], "ms": row["ms"],
           "kernel_ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
           "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
           "library_ms": None,
           **{k: row[k] for k in ("bytes", "operations", "bound_share",
                                  "int32_rate_ms",
                                  "operands_ms", "k1_ms", "fix_cells",
                                  "frames", "intra_frames", "encode_a")
                 if k in row}}
          for name, source, replaces, key, row in (
              ("dense_full_search", "losslessh264_tpu_torch/csrc/me_dense.cu",
               "losslessh264_tpu/ops/me.py:132", "K5", k5),
              ("mc_bucketed", "losslessh264_tpu_torch/csrc/mc_bucket.cu",
               "losslessh264_tpu/ops/mc.py:436", "K6", k6),
              ("residual_recon", "losslessh264_tpu_torch/csrc/residual_dec.cu",
               "losslessh264_tpu/decoder_jax.py:693", "K7", k7),
              ("inter_residual", "losslessh264_tpu_torch/csrc/residual_enc.cu",
               "losslessh264_tpu/encoder_jax.py:481", "K8", k8),
              ("edge_params_packed",
               "losslessh264_tpu_torch/csrc/deblock_params.cu",
               "losslessh264_tpu/ops/deblock.py:160", "K9", k9))),
        {"name": "mc_cells", "route": "cuda",
         "source": "losslessh264_tpu_torch/csrc/mc_cells.cu",
         "replaces": "losslessh264_tpu/decoder_jax.py:168",
         "launches": sum(v["K11"] for v in all_paths.values()),
         **{f"launches_per_{k}": v["K11"] for k, v in all_paths.items()},
         "max_abs_err": k11["max_abs_err"],
         "library_ms": None,
         **{k: k11[k] for k in ("ms", "kernel_ms", "plain_ms",
                                "bound_ms", "bound_by", "bytes",
                                "operations", "bound_share", "frames",
                                "inter_cells", "per_frame")}},
    ]}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
