#!/usr/bin/env python3
"""Time a kernel of the port (K1 csrc/halfpel.cu or K2 csrc/deblock.cu)
against other builds of it, or the port's kernel build against one nvcc
over all sources, in turns, on one GPU (run from the repo root on a
machine with an H100):

    git show 4d8d7c0:losslessh264_tpu_torch/csrc/halfpel.cu \\
        > build/k1_4d8d7c0.cu
    python3 tools/kernel_ab.py k1 build/k1_4d8d7c0.cu [more.cu ...]
    git show a3c3674:losslessh264_tpu_torch/csrc/deblock.cu \\
        > build/k2_a3c3674.cu
    python3 tools/kernel_ab.py k2 build/k2_a3c3674.cu [more.cu ...]
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

build: the wall time of _build.build() (one nvcc per csrc/*.cu, all
started together, then a link) against one nvcc over all the sources,
in four rounds whose order alternates; each build starts from nothing.
"""
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from losslessh264_tpu_torch import _build  # noqa: E402
from losslessh264_tpu_torch.cases import random_deblock_case  # noqa: E402
from losslessh264_tpu_torch.ops import deblock as tdb  # noqa: E402
from losslessh264_tpu_torch.ops import mc as tmc  # noqa: E402
from losslessh264_tpu_torch.ops.wavefront import diagonals  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(src):
    out = os.path.join(_build.BUILD_DIR, "ab_" + os.path.basename(src)
                       .replace(".cu", ".so"))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + ["-o", out, src],
                   check=True)
    return ctypes.CDLL(out)


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
    if len(sys.argv) < 2 or sys.argv[1] not in ("k1", "k2", "build"):
        sys.exit("usage: kernel_ab.py k1|k2 [build.cu ...] | build")
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA device")
    if sys.argv[1] == "build":
        print(cs.card_line(), flush=True)
        return ab_build()
    dev = torch.device("cuda", 0)
    libs = {"current": _build.lib()}
    for src in sys.argv[2:]:
        libs[os.path.basename(src)] = build(src)
    print(cs.card_line(), flush=True)
    (ab_k1 if sys.argv[1] == "k1" else ab_k2)(libs, dev)


if __name__ == "__main__":
    main()
