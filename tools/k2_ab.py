#!/usr/bin/env python3
"""Time K2 (csrc/deblock.cu) against other builds of it, in turns, on
one GPU (run from the repo root on a machine with an H100):

    git show a3c3674:losslessh264_tpu_torch/csrc/deblock.cu \
        > build/k2_a3c3674.cu
    python3 tools/k2_ab.py build/k2_a3c3674.cu [more.cu ...]

Each extra source is built with nvcc like the port's own kernels and
called through its C entry: `pip_deblock_wavefront` (one launch per MB
diagonal, the schedule uploaded from the host, as at a3c3674) or
`pip_deblock_frame` (one persistent launch, as now). On the seed-0
case of losslessh264_tpu_torch.cases (block-noise planes) the current
build must equal the plain torch version (another build that differs
is reported, and timed all the same: a diagnostic build may leave work
out on purpose); then each is timed, kernel only, by CUDA events over
30 launches, each on its own fresh copy of the planes, in four rounds
whose order alternates.
80x1 and 1x45 MBs are timed too: one MB row gives the time a CTA takes
per MB when it never waits, one MB column the time of a hand-off
between rows. Prints the card's name and power limit, every round's
time, and the median per frame and per step of the 2*(mb_h-1)+mb_w MB
chain.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from losslessh264_tpu_torch import _build  # noqa: E402
from losslessh264_tpu_torch.cases import random_deblock_case  # noqa: E402
from losslessh264_tpu_torch.ops import deblock as tdb  # noqa: E402
from losslessh264_tpu_torch.ops.wavefront import diagonals  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def build(src):
    out = os.path.join(_build.BUILD_DIR, "ab_" + os.path.basename(src)
                       .replace(".cu", ".so"))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + ["-o", out, src],
                   check=True)
    return ctypes.CDLL(out)


def launcher(lib, mb_w, mb_h, planes, P, dev):
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


def main():
    if not torch.cuda.is_available():
        sys.exit("k2_ab.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    libs = {"current": _build.lib()}
    for src in sys.argv[1:]:
        libs[os.path.basename(src)] = build(src)
    print(cs.card_line(), flush=True)
    for mb_w, mb_h in ((80, 45), (120, 68), (80, 1), (1, 45)):
        (Yw, Uw, Vw), _, params = random_deblock_case(mb_w, mb_h, 0, dev)
        want = tdb.deblock_wavefront_plain(mb_w, mb_h, Yw, Uw, Vw, params)
        P = tdb._pack_params(params).contiguous()
        for name, lib in libs.items():
            planes = [a.clone() for a in (Yw, Uw, Vw)]
            launcher(lib, mb_w, mb_h, planes, P, dev)()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(planes, want)):
                if name == "current":
                    sys.exit(f"K2 differs from the plain version at "
                             f"{mb_w}x{mb_h}")
                print(f"K2 {name} {mb_w}x{mb_h} MBs: DIFFERS from the plain "
                      "version (a diagnostic build, timed all the same)")
        names = list(libs)
        times = {n: [] for n in names}
        for rnd in range(4):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                times[name].append(cs.cuda_ms_each([
                    launcher(libs[name], mb_w, mb_h,
                             [a.clone() for a in (Yw, Uw, Vw)], P, dev)
                    for _ in range(32)]))
        steps = 2 * (mb_h - 1) + mb_w
        for name in names:
            med = float(np.median(times[name]))
            print(f"K2 {name} {mb_w}x{mb_h} MBs: kernel ms per frame "
                  f"{' '.join(f'{t:.4f}' for t in times[name])}, median "
                  f"{med:.4f} = {med * 1e3 / steps:.3f} us per step of "
                  f"{steps}", flush=True)


if __name__ == "__main__":
    main()
