#!/usr/bin/env python3
"""Time a kernel of the port (K1 csrc/halfpel.cu, K2 csrc/deblock.cu, K3
csrc/intra_dec.cu, K4 csrc/intra_enc.cu, K5 csrc/me_dense.cu, K6
csrc/mc_bucket.cu, K7 csrc/residual_dec.cu, K8 csrc/residual_enc.cu or K9
csrc/deblock_params.cu) against other builds of it,
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
    mkdir -p build/0ae75fb && for f in me_dense.cu mc_bucket.cu; do git \\
        show 0ae75fb:losslessh264_tpu_torch/csrc/$f > build/0ae75fb/$f; done
    python3 tools/kernel_ab.py k5 build/0ae75fb/me_dense.cu --parts
    python3 tools/kernel_ab.py k6 build/0ae75fb/mc_bucket.cu
    mkdir -p build/a86476d && for f in residual_dec.cu residual_enc.cu \\
        transform.cuh; do git show \\
        a86476d:losslessh264_tpu_torch/csrc/$f > build/a86476d/$f; done
    python3 tools/kernel_ab.py k7 build/a86476d/residual_dec.cu --parts
    python3 tools/kernel_ab.py k8 build/a86476d/residual_enc.cu --parts
    python3 tools/kernel_ab.py k9 build/other/deblock_params.cu
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

k5: `pip_me_dense` on cases.dense_search_case (noise, the reference a
strided slice as the encoder takes it) at 720p and 1080p at radius 16
and 720p at radius 8; each round the kernel alone, a CUDA graph's replays
of the bare entry (chip_smoke.kernel_device_ms), beside the bound at the
int8 rate. --parts adds, for each K5 source timed (the port's own and
0ae75fb's, e.g. `git show 0ae75fb:losslessh264_tpu_torch/csrc/me_dense.cu
> build/0ae75fb/me_dense.cu`), builds with one part of the search taken
out (K5_PARTS, under build/parts/).

k6: `pip_mc_bucket` of the port against 0ae75fb's (`git show
0ae75fb:losslessh264_tpu_torch/csrc/mc_bucket.cu >
build/0ae75fb/mc_bucket.cu`; an extra source whose entry takes no fix
list is taken to have 0ae75fb's entry, K6_OLD_ARGS) on every bucketed P
frame of synth720p and on the 720p cases of cases.K6_CASES: the kernel
alone (a CUDA graph's
replays of the bare entry) and the whole wrapper (the port's
mc_bucketed, against 0ae75fb's: K1, its Python loop of window checks, its
kernel, then the fix-up cells as torch ops, ops/mc._mc_fixups), CUDA
events around 10 back-to-back calls, in turns.

k7, k8: `pip_residual_dec` on every frame of synth720p (the rings its
decode gives each frame) and the 720p cases of cases.K7_CASES, or
`pip_residual_enc` on the P frames of encode A (golden A's encoder on
synth720p's frames 0-3) and the 720p cases of cases.K8_CASES; each round the
kernel alone, a CUDA graph's replays of the bare entry over copies of
the operands that leave L2 cold (chip_smoke.cold_calls), beside the
bound. An extra source is built alone, so transform.cuh must lie beside
it, and its entry must take the port's arguments. Each build's registers,
shared memory, stack and spills are printed first (cuobjdump
-res-usage). --parts adds builds of the port's own K7 or K8 with one part
taken out (RESIDUAL_PARTS below, under build/parts/): a store-only build,
the floor the card gives for the outputs, and one without the transforms;
they are not exact (reported, and timed all the same).

k9: `pip_deblock_params` on the deblocked frames of a synth720p decode
(the decoder's planes, as the decode hands them to K9) and the 720p
cases of cases.K9_CASES (the decoder's and the encoder's planes), timed
as k7 and k8 (chip_smoke.k9_bytes_ops for the bound).

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


def build_path(src):
    return os.path.join(_build.BUILD_DIR, "ab_" + label(src).replace(
        os.sep, "_").replace(".cu", ".so"))


def build(src):
    out = build_path(src)
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


# K5 builds with one part of the search taken out (--parts), for each K5
# source timed (the port's own and the others given): a part is the first
# of its edit lists whose every edit occurs once in that source (one list
# per design of the kernel).
#   k5_nokeys    the running keys and the partition sums: one min of the
#                8x8 sums per chunk of displacements (0ae75fb) or per
#                completed displacement (the sliding design)
#   k5_noperm    no byte permutes: every dx reads aligned words (0ae75fb's
#                design only; one more shared load a row)
#   k5_staging   no displacement visited: staging, key merge and stores
K5_PARTS = {
    # 0ae75fb's design (a lane per 8x8 quadrant, 4 dx per chunk), then the
    # sliding design (a lane per 16x8 half at one dx; it has no byte
    # permutes)
    "k5_nokeys": [
        [(re.compile(r"const uint32_t accs\[4\] = .*?k16 = min\(k16, "
                     r"key\(s16, idx\)\);\n        \}\n      \}", re.S),
          "k8 = min(k8, acc0 ^ acc1 ^ acc2 ^ acc3);")],
        [(re.compile(r"      if \(done\) \{.*?k\[i\] = min\(k\[i\], "
                     r"kk\[i\]\);\n        \}\n      \}", re.S),
          "      if (done) k[0] = min(k[0], acc[(s + 1) & 7][0] ^ "
          "acc[(s + 1) & 7][1]);")]],
    "k5_noperm": [
        [("const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];",
          "const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];"),
         ("__byte_perm(w0, w1, 0x4321)", "w1"),
         ("__byte_perm(w1, w2, 0x4321)", "w2"),
         ("__byte_perm(w0, w1, 0x5432)", "w2"),
         ("__byte_perm(w1, w2, 0x5432)", "w3"),
         ("__byte_perm(w0, w1, 0x6543)", "w3"),
         ("__byte_perm(w1, w2, 0x6543)", "w0")]],
    "k5_staging": [
        [("for (int dy = warp; dy < span; dy += nwarps) {",
          "for (int dy = warp; dy < 0; dy += nwarps) {")],
        [("for (int t0 = 0; t0 < span + 7; t0 += 8) {",
          "for (int t0 = 0; t0 < 0; t0 += 8) {")]],
}


# K7 / K8 builds with one part taken out (--parts), written under
# build/parts/ beside a copy of transform.cuh. Each edit is (old, new,
# times): `old` must occur `times` times.
#   k7_stores       no levels, PCM samples or prediction staged and no
#                   transforms: the per-MB bytes and ref_slot rows, then the
#                   stores of whatever shared memory holds (the floor the
#                   card gives for these outputs)
#   k7_notransform  everything staged and stored, no transforms
#   k8_stores       nothing staged and no lanes: the stores of whatever
#                   shared memory holds (the floor the card gives for these
#                   outputs)
#   k8_nolanes      everything staged and stored, the per-MB vectors and
#                   windows read, no lane's arithmetic
#   k8_noluma       as k8_nolanes for the luma lanes only
#   k8_nochroma     as k8_nolanes for the chroma lanes only
#   k8_notransform  the forward and inverse 4x4 transforms taken out
NO_TASKS = ("for (int t = warp; t < n8 + t4 + (nmb + 3) / 4; t += WARPS) {",
            "for (int t = warp; t < 0; t += WARPS) {", 1)
NO_LANES = [("luma_lane(a, sm, v, j, k, j < nmb);", ";", 1),
            ("chroma_lane(a, sm, v, j, c, k, j < nmb);", ";", 1)]
RESIDUAL_PARTS = {
    "k7_stores": ("residual_dec.cu", [
        ("stage_levels(a, sm, m0, nmb, tid);", ";", 1),
        ("stage_pred(a, sm, mby, mbx0, nmb, tid);", ";", 1), NO_TASKS]),
    "k7_notransform": ("residual_dec.cu", [NO_TASKS]),
    "k8_stores": ("residual_enc.cu", NO_LANES + [
        (re.compile(r"    stage_rows\(sm\.src_y.*?(    tx::cp_async_commit)",
                    re.S), r"\1", 1),
        (re.compile(r"    stage_rows\(sm\.src_c\[0\].*?"
                    r"(    tx::cp_async_commit)", re.S), r"\1", 1)]),
    "k8_nolanes": ("residual_enc.cu", NO_LANES),
    "k8_noluma": ("residual_enc.cu", NO_LANES[:1]),
    "k8_nochroma": ("residual_enc.cu", NO_LANES[1:]),
    "k8_notransform": ("residual_enc.cu", [
        ("tx::fdct4x4(w);", ";", 2), ("tx::idct4x4(w);", ";", 2)]),
}


def write_residual_parts(kernel):
    """Write the RESIDUAL_PARTS builds of K7 or K8, each in a directory of
    its own beside a copy of transform.cuh; returns their paths."""
    paths = []
    for name, (src, edits) in RESIDUAL_PARTS.items():
        if not name.startswith(kernel + "_"):
            continue
        text = open(os.path.join(CSRC, src)).read()
        for old, new, times in edits:
            if isinstance(old, str):
                hits = text.count(old)
                text = text.replace(old, new)
            else:
                text, hits = old.subn(new, text)
            if hits != times:
                raise SystemExit(f"{name}: {old!r} occurs {hits} times, not "
                                 f"{times}")
        out = os.path.join(_build.BUILD_DIR, os.pardir, "parts", name)
        os.makedirs(out, exist_ok=True)
        shutil.copy(os.path.join(CSRC, "transform.cuh"), out)
        path = os.path.join(out, src)
        with open(path, "w") as fh:
            fh.write(text)
        paths.append(os.path.normpath(path))
    return paths


def resources(so, kernel):
    """The registers, shared memory, stack and local memory (spills) of
    the kernel `kernel` (a function name's part) in the library `so`, as
    cuobjdump -res-usage reports them."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-res-usage", so], capture_output=True,
                         text=True).stdout.splitlines()
    return [" ".join(out[i + 1].split()) for i, line in enumerate(out[:-1])
            if line.strip().startswith("Function") and kernel in line]


def apply_edits(text, edits):
    """text with every edit applied, or None if one does not occur
    exactly once."""
    for old, new in edits:
        if isinstance(old, str):
            hits = text.count(old)
            text = text.replace(old, new)
        else:
            text, hits = old.subn(new, text)
        if hits != 1:
            return None
    return text


def write_k5_parts(srcs):
    """The K5_PARTS builds of each source in `srcs`, written under
    build/parts/<source's label>/; returns their paths."""
    paths = []
    for src in srcs:
        text = open(src).read()
        for name, designs in K5_PARTS.items():
            edited = next((t for t in (apply_edits(text, e)
                                       for e in designs) if t), None)
            if edited is None:
                print(f"{name}: no edit list fits {src}; not built")
                continue
            out = os.path.join(_build.BUILD_DIR, os.pardir, "parts",
                               label(src).replace(os.sep, "_")
                               .replace(".cu", ""))
            os.makedirs(out, exist_ok=True)
            path = os.path.normpath(os.path.join(out, name + ".cu"))
            with open(path, "w") as fh:
                fh.write(edited)
            paths.append(path)
    return paths


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


# K5's timed cases: (name, H, W, radius, plane kind, seed) of
# cases.dense_search_case, the reference a strided slice as the encoder
# takes it
K5_AB_CASES = [("720p radius 16", 720, 1280, 16, "random", 0),
               ("1080p radius 16", 1088, 1920, 16, "random", 1),
               ("720p radius 8", 720, 1280, 8, "random", 2)]


def k5_call(lib, cur, ref, out, radius):
    """A no-argument call of lib's pip_me_dense on (cur, ref) into out."""
    H, W = cur.shape
    args = [_P(cur.data_ptr()), cur.stride(0), cur.element_size(),
            _P(ref.data_ptr()), ref.stride(0), _P(out.data_ptr()), W // 16,
            H // 16, radius]

    def run(keep=(cur, ref, out)):
        _build.check(lib.pip_me_dense(*args, _build.stream(cur.device)),
                     "dense search")
    return run


def ab_k5(libs, dev):
    """K5 builds: each held to the plain search, then timed alone (a CUDA
    graph's replays of its bare C entry, chip_smoke.kernel_device_ms) in
    turns, beside the bounds of chip_smoke.k5_bytes_ops."""
    from losslessh264_tpu_torch.cases import dense_search_case
    from losslessh264_tpu_torch.ops import me as tme
    for name, H, W, R, kind, seed in K5_AB_CASES:
        cur, ref = dense_search_case(H, W, R, kind, seed, device=dev)
        triples = tme.dense_full_search_plain(cur, ref, R)
        want = torch.stack([torch.cat([t[i] for t in triples])
                            for i in range(3)])           # [3, 9n]
        n = (H // 16) * (W // 16)
        outs = {}
        for lname, lib in libs.items():
            out = torch.empty((3, 9 * n), dtype=torch.int32, device=dev)
            k5_call(lib, cur, ref, out, R)()
            torch.cuda.synchronize()
            outs[lname] = out
            if not torch.equal(out, want):
                if lname == "current":
                    sys.exit(f"K5 differs from the plain version at {name}")
                print(f"K5 {lname} {name}: DIFFERS from the plain version "
                      "(timed all the same)")
        times = rounds(list(libs), lambda lname: cs.kernel_device_ms(
            [k5_call(libs[lname], cur, ref, outs[lname], R)]))
        n_bytes, n_ops = cs.k5_bytes_ops(H, W, R, 4)
        b8, by8 = cs.bound_ms(n_bytes, n_ops, cs.INT8_OPS_PER_S)
        for lname, ts in times.items():
            med = float(np.median(ts))
            print(f"K5 {lname} {name}: kernel ms "
                  f"{' '.join(f'{t:.5f}' for t in ts)}, median {med:.5f}; "
                  f"{n_ops / 3 / med / 1e9:.1f} T pixel-displacements/s; "
                  f"bound {b8:.5f} ms by {by8} at the int8 rate, share "
                  f"{b8 / med:.4f}", flush=True)


# The K6 entry of 0ae75fb: the table's cells only; its wrapper checked
# the entries' windows in a Python loop and ran the fix-up cells after
# the kernel as torch ops (ops/mc._mc_fixups). A K6 source given to `k6`
# whose entry takes no fix list is taken to have this entry, so that the
# comparison with that kernel can be rerun; one that does is called as
# the port's own kernel is.
K6_OLD_ARGS = ([_P, _I, _P] + [_P, ctypes.c_longlong, _I, _P, _P, _I] * 2
                + [_P, _P, _P, _I, _I, _I, _P])


def old_k6(lib, ref_y, ref_u, ref_v, pad, p, mb_w, mb_h):
    """0ae75fb's K6 operands, as its k6_operands built them: (a no-argument
    call of lib's entry, its outputs). K1 launches here."""
    H, W = mb_h * 16, mb_w * 16
    cpad = pad // 2
    uniq = np.asarray(p["mc_uniq"]).astype(np.int64)
    slots = np.asarray(p["mc_slots"]).astype(np.int64)
    nuniq, nslots = int(p["mc_nuniq"]), int(p["mc_nslots"])
    hp0 = tmc._halfpel_planes_u8(ref_y[int(slots[0])])
    hps = [hp0, tmc._halfpel_planes_u8(ref_y[int(slots[1])])
           if nslots > 1 else hp0]
    for u in range(nuniq):                       # 0ae75fb's window checks
        e = [int(v) for v in uniq[u]]
        for dy, dx in (e[4:6], e[7:9]):
            y, x = pad - 2 + e[1] + dy, pad - 2 + e[2] + dx
            Hs, Ws = hps[e[0]].shape[1:]
            if not (0 <= y and y + H <= Hs and 0 <= x and x + W <= Ws):
                raise ValueError("half-pel slice leaves the plane")
        for dy in (0, 1):
            for dx in (0, 1):
                y, x = cpad + e[9] + dy, cpad + e[10] + dx
                Hs, Ws = ref_u.shape[1:]
                if not (0 <= y and y + H // 2 <= Hs and 0 <= x
                        and x + W // 2 <= Ws):
                    raise ValueError("chroma slice leaves the plane")
    ss = [int(slots[0]), int(slots[1]) if nslots > 1 else int(slots[0])]
    bucket = p["mc_bucket"].contiguous()
    table = np.ascontiguousarray(uniq, np.int32)
    dev = ref_y.device
    preds = (torch.empty((H, W), dtype=torch.int32, device=dev),
             torch.empty((H // 2, W // 2), dtype=torch.int32, device=dev),
             torch.empty((H // 2, W // 2), dtype=torch.int32, device=dev))
    args = [_P(table.ctypes.data), nuniq, _P(bucket.data_ptr())]
    for hp, sl in zip(hps, ss):
        args += [_P(hp.data_ptr()), hp.stride(0), hp.stride(1),
                 _P(ref_u[sl].data_ptr()), _P(ref_v[sl].data_ptr()),
                 ref_u.stride(1)]
    args += [_P(x.data_ptr()) for x in preds] + [mb_w, mb_h, pad]

    def run(keep=(table, bucket, hps, preds)):
        _build.check(lib.pip_mc_bucket(*args, _build.stream(dev)),
                     "bucketed MC")
    return run, preds


def k6_runs(libs, old_abi, name, args):
    """{build: (kernel call, wrapper call)}: the bare entry on its
    operands, and the whole mc_bucketed of that build (0ae75fb's: K1, its
    window checks, its kernel, then _mc_fixups)."""
    runs = {}
    for lname, lib in libs.items():
        if lname not in old_abi:
            ops, preds, keep = tmc.k6_operands(*args)

            def kern(lib=lib, ops=ops, keep=(keep, preds)):
                _build.check(lib.pip_mc_bucket(*ops, _build.stream(
                    args[0].device)), "bucketed MC")

            def wrap(lib=lib):
                if lib is _build.lib():
                    return tmc.mc_bucketed(*args)
                ops, preds, keep = tmc.k6_operands(*args)
                _build.check(lib.pip_mc_bucket(*ops, _build.stream(
                    args[0].device)), "bucketed MC")
                return preds
        else:
            kern, _ = old_k6(lib, *args)

            def wrap(lib=lib):
                run, preds = old_k6(lib, *args)
                run()
                return tmc._mc_fixups(*preds, *args)
        want = tmc.mc_bucketed_plain(*args)
        if not all(torch.equal(g, w) for g, w in zip(wrap(), want)):
            if lname == "current":
                sys.exit(f"K6 differs from the plain version at {name}")
            print(f"K6 {lname} {name}: DIFFERS from the plain version")
        runs[lname] = (kern, wrap)
    return runs


def ab_k6(libs, old_abi, dev):
    """K6 builds on every bucketed P frame of synth720p (the rings its
    decode gives each) and on the 720p cases of cases.K6_CASES: each
    build's whole mc_bucketed held to the plain version, then the kernel
    alone (a CUDA graph's replays of the bare entry) and the wrapper
    (CUDA events around 10 back-to-back calls) timed in turns; the frames'
    rows and their means."""
    from losslessh264_tpu_torch.cases import (K6_CASES, bucketed_mc_frames,
                                              random_mc_case)
    for lname, lib in libs.items():
        if lname in old_abi:
            lib.pip_mc_bucket.argtypes = K6_OLD_ARGS

    def one(name, args):
        runs = k6_runs(libs, old_abi, name, args)
        kt = rounds(list(libs), lambda n: cs.kernel_device_ms([runs[n][0]]))
        wt = rounds(list(libs), lambda n: cs.cuda_ms(runs[n][1], 10))
        fix = int((args[4]["mc_fix"] >= 0).sum())
        nb, _ = cs.k6_bytes_ops(*args)
        row = {}
        for lname in libs:
            row[lname] = (float(np.median(kt[lname])),
                          float(np.median(wt[lname])))
            print(f"K6 {lname} {name} (nuniq {args[4]['mc_nuniq']}, {fix} "
                  f"fix-up cells, bound {nb / cs.HBM_BYTES_PER_S * 1e3:.5f} "
                  f"ms): kernel ms {' '.join(f'{t:.5f}' for t in kt[lname])}"
                  f", median {row[lname][0]:.5f}; wrapper ms "
                  f"{' '.join(f'{t:.4f}' for t in wt[lname])}, median "
                  f"{row[lname][1]:.4f}", flush=True)
        return row

    with open(os.path.join(ROOT, "tests", "data", "synth720p.264"),
              "rb") as fh:
        data = fh.read()
    rows = [one(f"synth720p frame {i}", args)
            for i, *args in bucketed_mc_frames(data, dev)]
    for lname in libs:
        print(f"K6 {lname} synth720p, mean of {len(rows)} bucketed P "
              f"frames' medians: kernel ms "
              f"{np.mean([r[lname][0] for r in rows]):.5f}, wrapper ms "
              f"{np.mean([r[lname][1] for r in rows]):.4f}", flush=True)
    for name, mb_w, mb_h, *rest in K6_CASES:
        if mb_w == 80:
            *rings, pad, p = random_mc_case(mb_w, mb_h, *rest, device=dev)
            one(name, (*rings, pad, p, mb_w, mb_h))

def ab_residual(kernel, libs, dev):
    """K7 (`k7`), K8 (`k8`) or K9 (`k9`) builds: each held to the plain
    version, then
    timed alone in turns: a CUDA graph's replays of its bare C entry over
    copies of the operands that move more than 100 MB a turn, so that
    every launch finds its inputs out of L2 (chip_smoke.cold_calls,
    kernel_device_ms), beside the bound (chip_smoke.k7_bytes_ops,
    k8_bytes_ops). K7 on every frame of synth720p (on the rings its
    decode gives each) and on the 720p cases of cases.K7_CASES, K8 on the
    P frames of encode A (synth720p's frames 1-3, the calls of the golden
    configuration's encode) and the 720p cases of cases.K8_CASES, K9 on
    synth720p's deblocked frames and
    the 720p cases of cases.K9_CASES. A build must take the port's entry's
    arguments."""
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch import encoder_torch as et
    from losslessh264_tpu_torch.cases import (K7_CASES, K8_CASES, K9_CASES,
                                              HeldToPlain, golden_encoder,
                                              inter_residual_args,
                                              random_edge_case,
                                              random_inter_residual_case,
                                              random_residual_case,
                                              residual_frames)
    if kernel == "k9":
        entry, operands, plain = ("pip_deblock_params", tdb.k9_operands,
                                  tdb.edge_params_packed_plain)

        def cases():
            with open(os.path.join(ROOT, "tests", "data", "synth720p.264"),
                      "rb") as fh:
                data = fh.read()
            with HeldToPlain(tdb, "edge_params_packed", plain,
                             keep=25) as held:
                for _ in dt.TorchDecoder(data, device=dev).frames():
                    pass
            for i, args in enumerate(held.kept):
                yield (f"synth720p deblock {i}", args,
                       cs.k9_bytes_ops(args[0], args[1], args[2:]))
            for name, mb_w, mb_h, seed, kw in K9_CASES:
                if mb_w == 80:
                    args = (mb_w, mb_h, *random_edge_case(mb_w, mb_h, seed,
                                                          dev, **kw))
                    yield (name, args,
                           cs.k9_bytes_ops(mb_w, mb_h, args[2:]))
    elif kernel == "k7":
        entry, operands, plain = ("pip_residual_dec", dt.k7_operands,
                                  dt._residual_recon_plain)

        def cases():
            with open(os.path.join(ROOT, "tests", "data", "synth720p.264"),
                      "rb") as fh:
                data = fh.read()
            for i, mb_w, mb_h, p, *pred in residual_frames(data, dev):
                yield (f"synth720p frame {i}", (mb_w, mb_h, p, *pred),
                       cs.k7_bytes_ops(mb_w, mb_h, p, pred[0]))
            for name, mb_w, mb_h, seed, kw in K7_CASES:
                if mb_w == 80:
                    planes, *rings = random_residual_case(mb_w, mb_h, seed,
                                                          **kw)
                    p = dt.planes_to_torch(planes, dev)
                    pred = dt._inter_pred(mb_w, mb_h, p, *(torch.as_tensor(
                        r, device=dev) for r in rings)) or (None,) * 3
                    yield (name, (mb_w, mb_h, p, *pred),
                           cs.k7_bytes_ops(mb_w, mb_h, p, pred[0]))
    else:
        entry, operands, plain = ("pip_residual_enc", et.k8_operands,
                                  et.inter_residual_plain)

        def cases():
            # the P frames of encode A (the calls of its encode of
            # synth720p's first 4 frames), then the 720p random cases
            import json
            with open(os.path.join(ROOT, "tests", "data", "synth720p.264"),
                      "rb") as fh:
                data = fh.read()
            gold = json.load(open(cs.ENC_GOLDEN))
            src = [tuple(np.ascontiguousarray(p.cpu().numpy()) for p in yuv)
                   for _, yuv in zip(range(4), dt.TorchDecoder(
                       data, device=dev).frames())]
            enc = golden_encoder(gold["A"], gold["source"]["width"],
                                 gold["source"]["height"], dev)
            with HeldToPlain(et, "inter_residual", plain, keep=3) as held:
                for f in src:
                    enc.encode_frame(*f)
            for i, args in enumerate(held.kept):
                yield (f"encode A P frame {i + 1}", args,
                       cs.k8_bytes_ops(args[0], args[1], args[2:]))
            for name, mb_w, mb_h, seed, R, qp, rd_lam in K8_CASES:
                if mb_w == 80:
                    args = inter_residual_args(random_inter_residual_case(
                        mb_w, mb_h, seed, R, qp, rd_lam, dev))
                    yield (name, (mb_w, mb_h, *args),
                           cs.k8_bytes_ops(mb_w, mb_h, args))

    # the cases' groups: a stream's or an encode's frames, the random cases
    means, groups = {lname: [] for lname in libs}, []
    for name, args, (nb, no) in cases():
        groups.append(name.split(" frame")[0] if " frame " in name
                      else "random cases")
        want = plain(*args)
        want = (want,) if torch.is_tensor(want) else want
        for lname, lib in libs.items():
            ops, outs, _ = operands(*cs.clone_args(args))
            _build.check(getattr(lib, entry)(*ops, _build.stream(dev)),
                         kernel)
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                if lname == "current":
                    sys.exit(f"{kernel} differs from the plain version at "
                             f"{name}")
                print(f"{kernel} {lname} {name}: DIFFERS from the plain "
                      "version (timed all the same)")
        times = rounds(list(libs), lambda n: cs.kernel_device_ms(
            cs.cold_calls(getattr(libs[n], entry), operands, args, nb)))
        bound, by = cs.bound_ms(nb, no)
        for lname, ts in times.items():
            med = float(np.median(ts))
            means[lname].append(med)
            print(f"{kernel} {lname} {name}: kernel ms "
                  f"{' '.join(f'{t:.5f}' for t in ts)}, median {med:.5f}; "
                  f"bound {bound:.5f} ms by {by} ({nb} bytes), share "
                  f"{bound / med:.3f}", flush=True)
    for lname, ms in means.items():
        print(f"{kernel} {lname}: mean of {len(ms)} medians {np.mean(ms):.5f}"
              f" ms", flush=True)
        for group in sorted(set(groups)):
            sel = [t for t, g in zip(ms, groups) if g == group]
            print(f"{kernel} {lname}: {group}, mean of {len(sel)} medians "
                  f"{np.mean(sel):.5f} ms", flush=True)


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
                                                "k5", "k6", "k7", "k8",
                                                "k9", "build"):
        sys.exit("usage: kernel_ab.py k1|k2|...|k9 [build.cu ...] "
                 "[--parts] | build")
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA device")
    if sys.argv[1] == "build":
        print(cs.card_line(), flush=True)
        return ab_build()
    dev = torch.device("cuda", 0)
    libs = {"current": _build.lib()}
    srcs = [a for a in sys.argv[2:] if a != "--parts"]
    if "--parts" in sys.argv[2:]:
        if sys.argv[1] not in ("k3", "k4", "k5", "k7", "k8"):
            sys.exit("--parts is for k3, k4, k5, k7 and k8")
        srcs += (write_k5_parts([os.path.join(CSRC, "me_dense.cu")] + srcs)
                 if sys.argv[1] == "k5"
                 else write_residual_parts(sys.argv[1])
                 if sys.argv[1] in ("k7", "k8") else write_parts(sys.argv[1]))
    for src in srcs:
        libs[label(src)] = build(src)
    print(cs.card_line(), flush=True)
    if sys.argv[1] in ("k7", "k8"):
        fn = {"k7": "residual_dec", "k8": "residual_enc"}[sys.argv[1]]
        for name, so in [("current", _build.LIB_PATH)] + [
                (label(src), build_path(src)) for src in srcs]:
            for line in resources(so, fn):
                print(f"{sys.argv[1]} {name} resources: {line}", flush=True)
    if sys.argv[1] in ("k3", "k4"):
        return ab_intra(sys.argv[1], libs, dev)
    if sys.argv[1] == "k5":
        return ab_k5(libs, dev)
    if sys.argv[1] in ("k7", "k8", "k9"):
        return ab_residual(sys.argv[1], libs, dev)
    if sys.argv[1] == "k6":
        old_abi = {label(src) for src in srcs
                   if "const void* fix," not in open(src).read()}
        return ab_k6(libs, old_abi, dev)
    (ab_k1 if sys.argv[1] == "k1" else ab_k2)(libs, dev)


if __name__ == "__main__":
    main()
