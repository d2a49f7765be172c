#!/usr/bin/env python3
"""Run K6 (csrc/mc_bucket.cu), K7 (csrc/residual_dec.cu), K8
(csrc/residual_enc.cu) or K11 (csrc/mc_cells.cu) on the CPU, one
std::thread per CUDA thread, against their plain versions, exact.

    python3 tools/cuda_emu.py k6|k7|k8|k11 [SOURCE.cu] [--all] [--asan]

The source (the port's own by default; another one needs transform.cuh
beside it) is compiled by g++ against tools/cuda_emu/cuda_runtime.h, a
stand-in for CUDA's runtime (see its top for what it emulates and how),
with two rewrites: the `<<<grid, block, ...>>>` launch becomes a call of
emu::launch, and the bodies of transform.cuh's cp.async and bar.sync
helpers become the emulator's queued copies and barriers. The C entry is then called through ctypes
on CPU tensors (the wrapper's operands, decoder_torch.k7_operands or
encoder_torch.k8_operands with host=True) and every output is held to
the plain version with torch.equal (K6: ops/mc.k6_operands, K11:
ops/mc.k11_operands, with host=True too).

Cases: cases.K6_CASES, K7_CASES, K8_CASES or K11_CASES below 100 MBs
(K8 also a dc_shift case, whose no_res hinges on chroma DC levels);
--all adds the larger ones (a minute or more each). --asan builds with
AddressSanitizer and reruns itself with libasan preloaded, so a read past
a buffer's end shows. It checks a kernel's arithmetic, indexing and synchronisation
before a card sees it; it times nothing. Not a test of the suite: it
needs g++ with C++20 (std::barrier)."""
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from losslessh264_tpu_torch import _build  # noqa: E402
from losslessh264_tpu_torch import decoder_torch as dt  # noqa: E402
from losslessh264_tpu_torch import encoder_torch as et  # noqa: E402
from losslessh264_tpu_torch.cases import (K6_CASES, K7_CASES,  # noqa: E402
                                          K8_CASES, K11_CASES,
                                          inter_residual_args, k11_plain,
                                          random_cells_case,
                                          random_inter_residual_case,
                                          random_mc_case,
                                          random_residual_case)
from losslessh264_tpu_torch.ops import mc as tmc  # noqa: E402

CSRC = os.path.join(ROOT, "losslessh264_tpu_torch", "csrc")
STUB = os.path.join(ROOT, "tools", "cuda_emu")
OUT = os.path.join(ROOT, "build", "cuda_emu")
SOURCES = {"k6": "mc_bucket.cu", "k7": "residual_dec.cu",
           "k8": "residual_enc.cu", "k11": "mc_cells.cu"}
ENTRIES = {"k6": "pip_mc_bucket", "k7": "pip_residual_dec",
           "k8": "pip_residual_enc", "k11": "pip_mc_cells"}

# transform.cuh's cp.async and named-barrier helpers: (the definition's
# head, the body that replaces the asm)
HELPERS = [
    (r"template <int N>\s*__device__ __forceinline__ void cp_async\("
     r"void\* smem, const void\* gmem\)",
     "{ emu::cp_async(smem, gmem, N); }"),
    (r"void cp_async_commit\(\)", "{ emu::cp_async_commit(); }"),
    (r"void bar_sync\(int id, int n\)", "{ emu::bar_sync(id, n); }"),
    (r"template <int N>\s*__device__ __forceinline__ void cp_async_wait\(\)",
     "{ emu::cp_async_wait(N); }"),
]
LAUNCH = re.compile(r"(\w+)<<<([^,>]+),\s*([^,>]+)(?:,[^>]*)?>>>\((.*?)\);",
                    re.S)


def swap_body(text, head, body):
    """text with the braced body after the regex `head` replaced by
    `body`; the head must occur once."""
    m = list(re.finditer(head, text))
    if len(m) != 1:
        sys.exit(f"cuda_emu: {head!r} occurs {len(m)} times, not once")
    i = text.index("{", m[0].end())
    depth, j = 0, i
    while True:
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        j += 1
        if depth == 0:
            return text[:i] + body + text[j:]


def build(src, asan):
    """Compile `src` (with the .cuh files beside it) for the emulator;
    returns the loaded library."""
    name = os.path.basename(os.path.dirname(os.path.abspath(src)))
    out = os.path.join(OUT, name + ("_asan" if asan else ""))
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(os.path.dirname(os.path.abspath(src))):
        if f.endswith(".cuh"):
            text = open(os.path.join(os.path.dirname(src), f)).read()
            if f == "transform.cuh":
                for head, body in HELPERS:
                    text = swap_body(text, head, body)
            with open(os.path.join(out, f), "w") as fh:
                fh.write(text)
    text, hits = LAUNCH.subn(
        lambda m: f"emu::launch(dim3({m[2]}), dim3({m[3]}), [=] "
                  f"{{ {m[1]}({m[4]}); }});", open(src).read())
    if hits != 1:
        sys.exit(f"cuda_emu: {hits} launches in {src}, one expected")
    cpp = os.path.join(out, os.path.basename(src) + ".cpp")
    with open(cpp, "w") as fh:
        fh.write(text)
    so = os.path.join(out, os.path.basename(src) + ".so")
    cmd = [shutil.which("g++") or "g++", "-std=c++20", "-O1", "-g",
           "-pthread", "-shared", "-fPIC", "-I", STUB, "-I", out, "-o", so,
           cpp] + (["-fsanitize=address"] if asan else [])
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(so)
    for entry, args in _build._SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = args
            getattr(lib, entry).restype = ctypes.c_int
    return lib


def k7_cases(all_sizes):
    for name, mb_w, mb_h, seed, kw in K7_CASES:
        if mb_w * mb_h < 100 or all_sizes:
            planes, *rings = random_residual_case(mb_w, mb_h, seed, **kw)
            p = dt.planes_to_torch(planes, "cpu")
            pred = dt._inter_pred(mb_w, mb_h, p, *(
                torch.as_tensor(r) for r in rings)) or (None,) * 3
            yield name, (mb_w, mb_h, p, *pred)


def k8_cases(all_sizes):
    for name, mb_w, mb_h, seed, R, qp, rd_lam in K8_CASES:
        if mb_w * mb_h < 100 or all_sizes:
            yield name, (mb_w, mb_h, *inter_residual_args(
                random_inter_residual_case(mb_w, mb_h, seed, R, qp, rd_lam)))
    yield "9x4 R 2 per-MB qp rd_lam 144, chroma DC levels alone", (
        9, 4, *inter_residual_args(random_inter_residual_case(
            9, 4, 9, 2, "mb", 144, dc_shift=True)))


def k6_cases(all_sizes):
    for name, mb_w, mb_h, *rest in K6_CASES:
        if mb_w * mb_h < 100 or all_sizes:
            yield name, (*random_mc_case(mb_w, mb_h, *rest), mb_w, mb_h)


def k11_cases(all_sizes):
    for name, mb_w, mb_h, seed, kw in K11_CASES:
        if mb_w * mb_h < 100 or all_sizes:
            yield name, (*random_cells_case(mb_w, mb_h, seed, **kw), mb_w,
                         mb_h)


# kernel: (operands, plain version, cases)
KERNELS = {
    "k6": (tmc.k6_operands, tmc.mc_bucketed_plain, k6_cases),
    "k7": (dt.k7_operands, dt._residual_recon_plain, k7_cases),
    "k8": (et.k8_operands, et.inter_residual_plain, k8_cases),
    "k11": (tmc.k11_operands, k11_plain, k11_cases),
}


def main():
    argv = sys.argv[1:]
    if not argv or argv[0] not in SOURCES:
        sys.exit(__doc__)
    kernel, asan, all_sizes = argv[0], "--asan" in argv, "--all" in argv
    srcs = [a for a in argv[1:] if not a.startswith("--")]
    src = srcs[0] if srcs else os.path.join(CSRC, SOURCES[kernel])
    if asan and "LD_PRELOAD" not in os.environ:
        libasan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                                 capture_output=True, text=True).stdout
        env = dict(os.environ, LD_PRELOAD=libasan.strip(),
                   ASAN_OPTIONS="detect_leaks=0")
        os.execve(sys.executable, [sys.executable] + sys.argv, env)
    torch.set_num_threads(1)
    lib = build(src, asan)
    entry = getattr(lib, ENTRIES[kernel])
    operands, plain, cases = KERNELS[kernel]
    bad = 0
    for name, args in cases(all_sizes):
        ops, outs, _ = operands(*args, host=True)
        rc = entry(*ops, None)
        want = plain(*args)
        ok = rc == 0 and all(o.dtype == w.dtype and torch.equal(o, w)
                             for o, w in zip(outs, want))
        bad += not ok
        diff = [i for i, (o, w) in enumerate(zip(outs, want))
                if not torch.equal(o, w)]
        print(f"{kernel} {name}: {'exact' if ok else 'DIFFERS'}"
              + ("" if ok else f" (rc {rc}, outputs {diff})"), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
