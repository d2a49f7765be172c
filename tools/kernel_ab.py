#!/usr/bin/env python3
"""Time a kernel of the port (K1 csrc/halfpel.cu, K2 csrc/deblock.cu, K3
csrc/intra_dec.cu or K4 csrc/intra_enc.cu) against other builds of it,
or the port's kernel build against one nvcc over all sources, in turns,
on one GPU (run from the repo root on a machine with an H100):

    git show 4d8d7c0:losslessh264_tpu_torch/csrc/halfpel.cu \\
        > build/k1_4d8d7c0.cu
    python3 tools/kernel_ab.py k1 build/k1_4d8d7c0.cu [more.cu ...]
    git show a3c3674:losslessh264_tpu_torch/csrc/deblock.cu \\
        > build/k2_a3c3674.cu
    python3 tools/kernel_ab.py k2 build/k2_a3c3674.cu [more.cu ...]
    mkdir -p build/cfd9e6c && for f in intra_dec.cu intra_enc.cu \\
        intra_common.cuh wavefront.cuh; do git show \\
        cfd9e6c:losslessh264_tpu_torch/csrc/$f > build/cfd9e6c/$f; done
    python3 tools/kernel_ab.py k3 build/cfd9e6c/intra_dec.cu
    python3 tools/kernel_ab.py k4 build/cfd9e6c/intra_enc.cu --parts
    python3 tools/kernel_ab.py build

Each extra source is built with nvcc like the port's own kernels and
called through its C entry; "current" is the port's own build. On each
case the current build must equal the plain torch version (another
build that differs is reported, and timed all the same: a diagnostic
build may leave work out on purpose); then every build is timed, kernel
only, in four rounds whose order alternates. Prints the card's name and
power limit, every round's time and the median.

k1: the entries pip_halfpel_i32 and the uint8 one (pip_halfpel_u8_pitched,
or the contiguous pip_halfpel_u8 of builds before it) on random planes:
9x128, one warp's item of 4 rows (the time a launch takes when it has
almost nothing to do), and the three sizes of chip_smoke.K1_SIZES
(720p, 1080p, 2160p). Each round is the mean device time of one launch
in the replays of a CUDA graph of at least 30 launches, each on buffers
no longer in L2 (chip_smoke.kernel_device_ms, chip_smoke.k1_calls),
printed beside the bound (chip_smoke.bound_ms).

k2: `pip_deblock_wavefront` (one launch per MB diagonal, the schedule
uploaded from the host, as at a3c3674) or `pip_deblock_frame` (one
persistent launch) on the seed-0 case of losslessh264_tpu_torch.cases
(block-noise planes) at 80x45 (720p) and 120x68 (1080p) MBs, and at 80x1
and 1x45 MBs: one MB row gives the time a CTA takes per MB when it never
waits, one MB column the time of a hand-off between rows. Each round is
CUDA events over 30 launches, each on its own fresh copy of the planes
(the kernel filters in place), printed per frame and per step of the
2*(mb_h-1)+mb_w MB chain.

k3: `pip_intra_dec` on cases.random_intra_case (every class and mode,
slices starting mid-row) at 80x45 MBs (720p), 80x1 and 1x45 MBs, and a
batch of 4 frames at 80x45. k4: `pip_intra_enc` on
cases.random_intra_encode_case (all MBs intra, qp 28) at 80x45, 80x1 and
1x45 MBs. One MB row never waits, so it gives the MB's own compute time
per step; one MB column waits on the row above at every MB, so it gives
the compute plus the hand-off. Each round is CUDA events over 20
launches, each on its own copy of the planes (and for K4 the symbol
rows: the kernels write them in place; chip_smoke.k3_launchers,
k4_launchers), printed per launch and per step of the MB chain
(chip_smoke.chain_steps: 2*(mb_h-1)+mb_w, one MB column mb_h). An extra
source is built alone, so its headers (intra_common.cuh, wavefront.cuh)
lie beside it. --parts adds builds of the port's own K3 or K4 with one
part of the MB step taken out (PARTS below, written under build/parts/):
they are not exact (reported, and timed all the same), and their times
split a step into its parts.

build: the wall time of _build.build() (one nvcc per csrc/*.cu, all
started together, then a link) against one nvcc over all the sources,
in four rounds whose order alternates; each build starts from nothing.
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "losslessh264_tpu_torch", "csrc")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from losslessh264_tpu_torch import _build  # noqa: E402
from losslessh264_tpu_torch.cases import random_deblock_case  # noqa: E402
from losslessh264_tpu_torch.ops import deblock as tdb  # noqa: E402
from losslessh264_tpu_torch.ops import mc as tmc  # noqa: E402
from losslessh264_tpu_torch.ops.wavefront import diagonals  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def label(src):
    """A build's name: its directory and file, build/cfd9e6c/intra_dec.cu ->
    cfd9e6c/intra_dec.cu."""
    return os.path.join(os.path.basename(os.path.dirname(src)),
                        os.path.basename(src))


def build(src):
    out = os.path.join(_build.BUILD_DIR, "ab_" + label(src).replace(
        os.sep, "_").replace(".cu", ".so"))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS
                   + ["-Xptxas", "-v", "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    for name, args in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    return lib


def rounds(names, time_one):
    """{name: [4 times]}, the builds timed in turns, order alternating."""
    times = {n: [] for n in names}
    for rnd in range(4):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            times[name].append(time_one(name))
    return times


def k1_launcher(lib, x, entry):
    """chip_smoke.k1_launcher, or for a build before the pitched uint8
    entry (4d8d7c0) its contiguous pip_halfpel_u8, kept so that the
    comparison with that kernel can be rerun."""
    if entry == "i32" or hasattr(lib, "pip_halfpel_u8_pitched"):
        return cs.k1_launcher(lib, x, entry)
    Hp, Wp = x.shape
    out = torch.empty((4, Hp - 5, Wp - 5), dtype=torch.uint8,
                      device=x.device)
    fn = lib.pip_halfpel_u8
    fn.argtypes = [_P, _P, _I, _I, _P]
    fn.restype = _I
    args = [_P(x.data_ptr()), _P(out.data_ptr()), Hp, Wp]

    def run(keep=(x, out)):
        _build.check(fn(*args, _build.stream(x.device)), "halfpel")
    return run, out


def ab_k1(libs, dev):
    rng = np.random.default_rng(0)
    sizes = dict({"one item": (9, 128)}, **cs.K1_SIZES)
    for size, (Hp, Wp) in sizes.items():
        x = torch.as_tensor(rng.integers(0, 256, (Hp, Wp), dtype=np.uint8),
                            device=dev)
        want = tmc.halfpel_planes_plain(x)
        ops = cs.K1_OPS_PER_POSITION * (Hp - 5) * (Wp - 5)
        for entry in ("u8", "i32"):
            for name, lib in libs.items():
                run, out = k1_launcher(lib, x, entry)
                run()
                torch.cuda.synchronize()
                if not torch.equal(out.to(torch.int32), want):
                    if name == "current":
                        sys.exit(f"K1 {entry} differs from the plain "
                                 f"version at {size}")
                    print(f"K1 {name} {entry} {size}: DIFFERS from the "
                          "plain version (timed all the same)")
            times = rounds(list(libs), lambda name: cs.kernel_device_ms(
                cs.k1_calls(libs[name], x, entry, launcher=k1_launcher)))
            bound, by = cs.bound_ms(cs.k1_bytes(Hp, Wp, entry), ops)
            for name, ts in times.items():
                med = float(np.median(ts))
                print(f"K1 {name} {entry} entry {size} {Hp}x{Wp}: kernel "
                      f"ms {' '.join(f'{t:.5f}' for t in ts)}, median "
                      f"{med:.5f}; bound {bound:.5f} ms by {by}, share "
                      f"{bound / med:.3f}", flush=True)


def k2_launcher(lib, mb_w, mb_h, planes, P, dev):
    """A no-argument call of lib's K2 entry on `planes`, in place."""
    if hasattr(lib, "pip_deblock_frame"):
        lib.pip_deblock_frame.argtypes = [_P, _P, _P, _I, _I, _P, _P, _I,
                                          _I, _P]
        return cs.k2_launcher(lib, mb_w, mb_h, planes, P, dev)
    # the per-diagonal entry of a3c3674, kept so that the comparison
    # with that kernel can be rerun
    Y, U, V = planes
    fn = lib.pip_deblock_wavefront
    fn.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P]
    diags = diagonals(mb_w, mb_h)
    live = torch.as_tensor(np.ascontiguousarray(diags[diags >= 0],
                                                np.int32), device=dev)
    off = np.concatenate([[0], np.cumsum((diags >= 0).sum(1))]) \
        .astype(np.int32)
    args = [_P(Y.data_ptr()), _P(U.data_ptr()), _P(V.data_ptr()),
            Y.stride(0), U.stride(0), _P(P.data_ptr()), _P(live.data_ptr()),
            off.ctypes.data_as(_P), diags.shape[0], mb_w, _build.stream(dev)]

    def run(keep=(planes, P, live, off)):
        _build.check(fn(*args), "deblock")
    return run


def ab_k2(libs, dev):
    for mb_w, mb_h in ((80, 45), (120, 68), (80, 1), (1, 45)):
        (Yw, Uw, Vw), _, params = random_deblock_case(mb_w, mb_h, 0, dev)
        want = tdb.deblock_wavefront_plain(mb_w, mb_h, Yw, Uw, Vw, params)
        P = tdb._pack_params(params).contiguous()
        for name, lib in libs.items():
            planes = [a.clone() for a in (Yw, Uw, Vw)]
            k2_launcher(lib, mb_w, mb_h, planes, P, dev)()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(planes, want)):
                if name == "current":
                    sys.exit(f"K2 differs from the plain version at "
                             f"{mb_w}x{mb_h}")
                print(f"K2 {name} {mb_w}x{mb_h} MBs: DIFFERS from the plain "
                      "version (a diagnostic build, timed all the same)")
        times = rounds(list(libs), lambda name: cs.cuda_ms_each([
            k2_launcher(libs[name], mb_w, mb_h,
                        [a.clone() for a in (Yw, Uw, Vw)], P, dev)
            for _ in range(32)]))
        steps = 2 * (mb_h - 1) + mb_w
        for name, ts in times.items():
            med = float(np.median(ts))
            print(f"K2 {name} {mb_w}x{mb_h} MBs: kernel ms per frame "
                  f"{' '.join(f'{t:.4f}' for t in ts)}, median "
                  f"{med:.4f} = {med * 1e3 / steps:.3f} us per step of "
                  f"{steps}", flush=True)


# K3 / K4 builds with one part of the MB step taken out (--parts):
#   k4_noi4         the I4x4 warps skip the search
#   k4_noi16        the I16x16 warp skips its mode, transform and recon
#   k4_nochroma     the chroma warp skips its mode, transform and recon
#   k4_nocompute    all three: staging, hand-off, decision and stores only
#   k4_notransform  the chosen I4x4 modes skip their transform and recon
#   k4_barriers     the I4x4 warps only pass their two barriers per level
#   k4_nofence      the publish stores its flag without __threadfence
#   k3_noluma       the luma warps reconstruct nothing
#   k3_nochroma     the chroma warps reconstruct nothing
#   k3_nocompute    both
#   k3_nofence      the publish stores its flag without __threadfence
I4 = ("encode_i4(sm, src, qp, aL, aT, aTR, t);", ";")
I16 = ("encode_i16(sm, src, qp, aL, aT, lane);", ";")
CHROMA = (re.compile(r"encode_chroma\(sm, src \+ 256.*?row, lane\);", re.S),
          ";")
LUMA = [("recon_i16(sm, clampi(inf[6], 0, 3), aL, aT, res, tid);", ";"),
        ("recon_i8(sm, inf + 8, aL, aT, aTL, aTR, res, tid);", ";"),
        ("recon_i4(sm, inf + 8, aL, aT, aTR, res, lane, kinds);", ";")]
CCHROMA = (re.compile(r"recon_chroma\(warp == 2 \? sm\.cu.*?lane\);", re.S),
           ";")
NOTRANSFORM = ("if (__any_sync(FULL, chosen)) {",
               "if (__any_sync(FULL, chosen) && t.warp < 0) {")
NOSEARCH = ("if (valid || t.warp == 4) {", "if (t.warp < 0) {")
PARTS = {
    "k4_noi4": ("intra_enc.cu", [I4]),
    "k4_noi16": ("intra_enc.cu", [I16]),
    "k4_nochroma": ("intra_enc.cu", [CHROMA]),
    "k4_nocompute": ("intra_enc.cu", [I4, I16, CHROMA]),
    "k4_notransform": ("intra_enc.cu", [NOTRANSFORM]),
    "k4_barriers": ("intra_enc.cu", [NOTRANSFORM, NOSEARCH]),
    "k4_nofence": ("intra_enc.cu", []),
    "k3_noluma": ("intra_dec.cu", LUMA),
    "k3_nochroma": ("intra_dec.cu", [CCHROMA]),
    "k3_nocompute": ("intra_dec.cu", LUMA + [CCHROMA]),
    "k3_nofence": ("intra_dec.cu", []),
}
# edits of csrc/wavefront.cuh, which every variant carries beside it
NOFENCE = ("    __threadfence();\n    st_release(prog, done);",
           "    st_release(prog, done);")


def write_parts(kernel):
    """Write the diagnostic builds of K3 or K4 (PARTS), each in a
    directory of its own beside copies of the headers (build() compiles a
    source alone); returns their paths."""
    paths = []
    for name, (src, edits) in PARTS.items():
        if not name.startswith(kernel + "_"):
            continue
        text = open(os.path.join(CSRC, src)).read()
        for old, new in edits:
            if isinstance(old, str):
                hits = text.count(old)
                text = text.replace(old, new)
            else:
                text, hits = old.subn(new, text)
            if hits != 1:
                raise SystemExit(f"{name}: {old!r} occurs {hits} times, "
                                 "not once")
        out = os.path.join(_build.BUILD_DIR, os.pardir, "parts", name)
        os.makedirs(out, exist_ok=True)
        shutil.copy(os.path.join(CSRC, "intra_common.cuh"), out)
        wave = open(os.path.join(CSRC, "wavefront.cuh")).read()
        if name.endswith("_nofence"):
            if wave.count(NOFENCE[0]) != 1:
                raise SystemExit(f"{name}: the publish_block fence not found")
            wave = wave.replace(*NOFENCE)
        with open(os.path.join(out, "wavefront.cuh"), "w") as fh:
            fh.write(wave)
        path = os.path.join(out, src)
        with open(path, "w") as fh:
            fh.write(text)
        paths.append(os.path.normpath(path))
    return paths


def ab_intra(kernel, libs, dev):
    """K3 or K4: each build held to the plain version, then timed per
    launch and per chain step in turns."""
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import encoder_torch as et
    from losslessh264_tpu_torch.cases import (random_intra_case,
                                              random_intra_encode_case)
    shapes = [(80, 45, 1), (80, 1, 1), (1, 45, 1)]
    if kernel == "k3":
        shapes.append((80, 45, 4))
    for seed, (mb_w, mb_h, B) in enumerate(shapes):
        if kernel == "k3":
            work = random_intra_case(mb_w, mb_h, B, seed, dev)
            want = dt._intra_scan_plain(mb_w, mb_h, *work,
                                        dt.diagonals(mb_w, mb_h))

            def calls(lib, count):
                return cs.k3_launchers(lib, mb_w, mb_h, work[:6], work[6],
                                       count)

            def equal(mine):
                return all(torch.equal(g.reshape(w.shape), w)
                           for g, w in zip(mine[:3], want))
        else:
            args = cs.encode_args(random_intra_encode_case(
                mb_w, mb_h, 2 * seed, 28), dev)
            want = et.intra_wavefront_plain(mb_w, mb_h, *args)

            def calls(lib, count):
                return cs.k4_launchers(lib, mb_w, mb_h, args, count)

            def equal(mine):
                return all(torch.equal(g, w) for g, w in zip(
                    et.k4_results(mb_w, mb_h, mine), want))
        for name, lib in libs.items():
            call = calls(lib, 1)[0]
            call()
            torch.cuda.synchronize()
            if not equal(call.__defaults__[0]):   # the call's operands
                if name == "current":
                    sys.exit(f"{kernel.upper()} differs from the plain "
                             f"version at {mb_w}x{mb_h} x {B}")
                print(f"{kernel.upper()} {name} {mb_w}x{mb_h} x {B}: "
                      "DIFFERS from the plain version (timed all the same)")
        times = rounds(list(libs), lambda name: cs.cuda_ms_each(
            calls(libs[name], 22)))
        steps = cs.chain_steps(mb_w, mb_h)
        for name, ts in times.items():
            med = float(np.median(ts))
            print(f"{kernel.upper()} {name} {mb_w}x{mb_h} MBs x {B}: "
                  f"kernel ms per launch {' '.join(f'{t:.4f}' for t in ts)}"
                  f", median {med:.4f} = {med * 1e3 / steps:.3f} us per "
                  f"step of {steps}", flush=True)


def ab_build():
    """The port's build (_build.build) against one nvcc over all of
    csrc/*.cu, wall time, each from nothing."""
    one = os.path.join(_build.BUILD_DIR, "ab_one_nvcc.so")

    def time_one(name):
        for f in (_build.LIB_PATH, one):
            if os.path.exists(f):
                os.remove(f)
        t0 = time.perf_counter()
        if name == "one nvcc per source":
            _build.build()
        else:
            subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS
                           + ["-o", one] + _build.sources(), check=True)
        return time.perf_counter() - t0
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    times = rounds(["one nvcc per source", "one nvcc over all"], time_one)
    for name, ts in times.items():
        print(f"build {name} ({len(_build.sources())} sources): s "
              f"{' '.join(f'{t:.2f}' for t in ts)}, median "
              f"{float(np.median(ts)):.2f} ({os.cpu_count()} CPUs)",
              flush=True)


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in ("k1", "k2", "k3", "k4",
                                                "build"):
        sys.exit("usage: kernel_ab.py k1|k2|k3|k4 [build.cu ...] [--parts] "
                 "| build")
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA device")
    if sys.argv[1] == "build":
        print(cs.card_line(), flush=True)
        return ab_build()
    dev = torch.device("cuda", 0)
    libs = {"current": _build.lib()}
    srcs = [a for a in sys.argv[2:] if a != "--parts"]
    if "--parts" in sys.argv[2:]:
        if sys.argv[1] not in ("k3", "k4"):
            sys.exit("--parts is for k3 and k4")
        srcs += write_parts(sys.argv[1])
    for src in srcs:
        libs[label(src)] = build(src)
    print(cs.card_line(), flush=True)
    if sys.argv[1] in ("k3", "k4"):
        return ab_intra(sys.argv[1], libs, dev)
    (ab_k1 if sys.argv[1] == "k1" else ab_k2)(libs, dev)


if __name__ == "__main__":
    main()
