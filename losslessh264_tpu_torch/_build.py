"""Build and load the port's compiled code at first use: the CUDA
kernels (csrc/*.cu) and the decoder's host code (csrc/*.cpp: the plan and
the symbol layer's parse-ahead thread).

The kernels are compiled by nvcc into one shared library with a plain C
interface, build/kernels/libpip_kernels.so under the checkout, and
loaded with ctypes. Each C entry point takes device pointers, sizes and
the CUDA stream, launches on that stream, and returns
cudaGetLastError(); `check` raises when that is not 0. The host sources
are plain C++ that g++ compiles into build/host/libpip_plan.so, apart
from the kernels, so that a machine without nvcc (the CPU tests') builds
and runs them; that library includes native/src's headers and links
against native/libh264pip.so (the symbol parse, csrc/sym_planes.cpp), so
native.load() builds that first. Each library is rebuilt only when one
of its sources (for the kernels, a header csrc/*.cuh too; for the host
library, a header native/src/*.h, whose struct layouts are compiled into
both libraries) is newer than it. Nothing here runs at import: the CPU
tests import every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
_SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libpip_kernels.so")
HOST_BUILD_DIR = os.path.join(_ROOT, "build", "host")
HOST_LIB_PATH = os.path.join(HOST_BUILD_DIR, "libpip_plan.so")
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC"]
# one source (or the objects) straight to a shared library
NVCC_FLAGS = COMPILE_FLAGS + ["-shared"]
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
# native/libh264pip.so, found beside the host library's checkout at load
HOST_LINK = ["-L", os.path.join(_ROOT, "native"), "-lh264pip",
             "-Wl,-rpath,$ORIGIN/../../native"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (all return int, a cudaError_t)
_SIGNATURES = {
    # (src, dst, Hp, Wp, stream)
    "pip_halfpel_i32": [_P, _P, _I, _I, _P],
    # (src, dst, Hp, Wp, pitch, stream)
    "pip_halfpel_u8_pitched": [_P, _P, _I, _I, _I, _P],
    # (Y, U, V, y_stride, c_stride, params, sync scratch [1 + 2*mb_h],
    #  mb_w, mb_h, stream)
    "pip_deblock_frame": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P],
    # (host plane descriptors [10 x 6] int64, tables, chroma_qp_offset,
    #  out [n, 384], mb_w, mb_h, stream)
    "pip_deblock_params": [_P, _P, _I, _P, _I, _I, _P],
    # (Y, U, V, res_y, res_u, res_v, MB rows, tables, sync scratch
    #  [1 + B*mb_h], mb_w, mb_h, B, stream)
    "pip_intra_dec": [_P] * 9 + [_I, _I, _I, _P],
    # (Y, U, V, srcY, srcU, srcV, MB rows, qp, qpc, tables, symbol rows,
    #  sync scratch [1 + mb_h], mb_w, mb_h, stream)
    "pip_intra_enc": [_P] * 12 + [_I, _I, _P],
    # (cur, cur row stride, cur element bytes, ref, ref row stride, out
    #  [3, 9n], mb_w, mb_h, radius, stream)
    "pip_me_dense": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _P],
    # (host table [32, 16], nuniq, bucket, fix list, ref_slot, its
    #  element bytes, mv, its element bytes, then per active slot 0 and 1:
    #  K1 planes, plane stride, row pitch, ring slot; luma ring, slot
    #  stride, row stride, Hp, Wp; U ring, V ring, slot stride, row
    #  stride, Hcp, Wcp; R; pred_y, pred_u, pred_v, mb_w, mb_h, pad,
    #  stream)
    "pip_mc_bucket": [_P, _I, _P, _P, _P, _P] + [_P, _L, _I, _I] * 2
    + [_P, _L, _I, _I, _I, _P, _P, _L, _I, _I, _I, _I]
    + [_P, _P, _P, _I, _I, _I, _P],
    # (ref_slot, mv, wp_luma, wp_cb, wp_cr, wp_cmask (all four or none
    #  null); luma ring, slot stride, row stride, Hp, Wp; U ring, V ring,
    #  slot stride, row stride, Hcp, Wcp; R; pred_y, pred_u, pred_v, mb_w,
    #  mb_h, pad, stream)
    "pip_mc_cells": [_P] * 6 + [_P, _L, _I, _I, _I, _P, _P, _L, _I, _I, _I,
                                _I] + [_P, _P, _P, _I, _I, _I, _P],
    # (mb_class, qp, cbp_luma, cbp_chroma, transform8, luma_ac, luma_dc,
    #  luma8, chroma_ac, chroma_dc, ref_slot, pcm, w4 x6, w8 x2,
    #  use_scaling, chroma qp offsets x2, pred_y, pred_u, pred_v, Yw, Uw,
    #  Vw, res_y, res_u, res_v, mb_w, mb_h, stream)
    "pip_residual_dec": [_P] * 20 + [_I] * 3 + [_P] * 9 + [_I, _I, _P],
    # (src Y, U, V, their element bytes, Y and chroma row strides, pred_q,
    #  mvq_x, mvq_y, best_sad, part, xoffC, qp, qpc, ref U, ref V, ref rows,
    #  ref cols, rd_lam, use_intra, no_res, part out, mv8, luma levels,
    #  cdc, cac, tile_y, tile_u, tile_v, mb_w, mb_h, stream)
    "pip_residual_enc": [_P] * 3 + [_I] * 3 + [_P] * 10 + [_I] * 3
    + [_P] * 10 + [_I, _I, _P],
}
# the host code's C entry points (all return int; the plan's 0, or 1 for
# bad sizes)
_HOST_SIGNATURES = {
    # (mb_class, transform8, cbp_luma [n] uint8, luma_ac [n, 16, 4, 4],
    #  luma8 [n, 4, 8, 8] int16, n, out [n, 16] int64)
    "pip_plan_nnz": [_P] * 5 + [_I, _P],
    # (ref_slot [n, 16] int32, mv [n, 16, 2] int16, mb_w, mb_h, pad,
    #  MC_CAP, MC_SLOT_CAP, MC_FIX_CAP, MC_MV_MAX, QTAB [16, 6] int32;
    #  out: uniq [MC_CAP, 16], slots [MC_SLOT_CAP] int32, bucket [n, 16]
    #  uint8, fix [MC_FIX_CAP], info [4] int32)
    "pip_plan_mc": [_P, _P] + [_I] * 7 + [_P] * 6,
    # the symbol layer's parse-ahead worker (csrc/sym_ahead.cpp):
    # (handle, its next, planes and close functions (pip_pooled_next,
    #  pip_pooled_planes, pip_pooled_close), depth, sizes [2, 31] int64;
    #  out: the worker)
    "pip_ahead_start": [_P] * 4 + [_I, _P, _P],
    # (worker, block; out: [11] int64, err, err_cap)
    "pip_ahead_take": [_P, _I, _P, _P, ctypes.c_size_t],
    "pip_ahead_queued": [_P],
    "pip_ahead_stop": [_P],
    # (buffer, its bytes)
    "pip_ahead_free": [_P, ctypes.c_size_t],
    "pip_ahead_live": [],
    # the port's handle on the native parse (csrc/sym_planes.cpp), whose
    # next, planes and close the worker calls: (data, size, err, err_cap)
    # -> the handle or null
    "pip_pooled_open": ([ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                         ctypes.c_size_t], _P),
    "pip_pooled_close": ([_P], None),
    # (out: [2] int64, the FramePlanes the pool holds and their bytes)
    "pip_pooled_kept": [_P],
}

_lib = None
_host_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def count_launch(wrapper):
    """Add one to `wrapper.launches`. A bare `+= 1` is a read and a write
    that two host threads (the GOP-parallel decode's workers) can
    interleave and lose a count, so it is taken under a lock."""
    with _count_lock:
        wrapper.launches += 1


def sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def host_sources(root=_ROOT):
    return sorted(glob.glob(os.path.join(
        root, "losslessh264_tpu_torch", "csrc", "*.cpp")))


def host_inputs(root=_ROOT):
    """What the host library of the checkout at `root` is built from: its
    sources and the native/src headers they may include."""
    return host_sources(root) + sorted(glob.glob(os.path.join(
        root, "native", "src", "*.h")))


def _nvcc():
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def _stale(path, srcs):
    if not os.path.exists(path):
        return True
    t = os.path.getmtime(path)
    return any(os.path.getmtime(s) > t for s in srcs)


def needs_build():
    return _stale(LIB_PATH, sources()
                  + glob.glob(os.path.join(_SRC_DIR, "*.cuh")))


def needs_host_build(root=_ROOT):
    return _stale(os.path.join(root, "build", "host", "libpip_plan.so"),
                  host_inputs(root))


def build():
    """Compile csrc/*.cu for sm_90a, one nvcc per source, all at once,
    and link them into LIB_PATH; returns nvcc's output (register and
    spill report included)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for src in sources():
            obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}."
                               f"{os.getpid()}.o")
            cmd = [nvcc] + COMPILE_FLAGS + ["-Xptxas", "-v", "-c", "-o",
                                            obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, _, proc in jobs]
        for cmd, out, rc in outs:
            if rc != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                                   + out)
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp] + [o for _, o, _ in jobs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + " ".join(cmd) + "\n"
                               + res.stdout + res.stderr)
    finally:
        for _, obj, proc in jobs:
            proc.wait()
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)
    return "".join(out for _, out, _ in outs) + res.stdout + res.stderr


def build_host():
    """Compile csrc/*.cpp with g++ into HOST_LIB_PATH (through a file of
    this process's own, so that processes building at once do not
    collide), against native/libh264pip.so, which has to be built;
    returns g++'s output."""
    os.makedirs(HOST_BUILD_DIR, exist_ok=True)
    tmp = f"{HOST_LIB_PATH}.{os.getpid()}.tmp"
    cmd = (["g++"] + GXX_FLAGS
           + ["-I", os.path.join(_ROOT, "native", "src"), "-o", tmp]
           + host_sources() + HOST_LINK)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("g++ failed:\n" + " ".join(cmd) + "\n"
                           + res.stdout + res.stderr)
    os.replace(tmp, HOST_LIB_PATH)
    return res.stdout + res.stderr


def _load(path, signatures):
    """Load `path` and type its entry points: each signature is the
    argtypes of a function returning int, or (argtypes, restype)."""
    so = ctypes.CDLL(path)
    for name, sig in signatures.items():
        args, res = sig if isinstance(sig, tuple) else (sig, ctypes.c_int)
        fn = getattr(so, name)
        fn.argtypes = args
        fn.restype = res
    return so


def lib():
    """The loaded kernel library, built first if a source changed. The
    first call builds under a lock, so threads that launch at once share
    one build."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            if needs_build():
                build()
            _lib = _load(LIB_PATH, _SIGNATURES)
    return _lib


def host_lib():
    """The loaded host library, built first if a source changed, under
    the same lock and rule as lib(), after native/libh264pip.so."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    from . import native
    native.load()
    with _lib_lock:
        if _host_lib is None:
            if needs_host_build():
                build_host()
            _host_lib = _load(HOST_LIB_PATH, _HOST_SIGNATURES)
    return _host_lib


def host_array(a, dtype, shape, what):
    """The address of numpy array `a` for a host entry point, as a
    c_void_p; raises ValueError unless `a` has exactly `dtype` and
    `shape` and is C-contiguous (nothing is copied or converted)."""
    if not isinstance(a, np.ndarray) or a.dtype != dtype \
            or a.shape != tuple(shape) or not a.flags.c_contiguous:
        got = (f"{a.dtype} {a.shape}, C-contiguous "
               f"{a.flags.c_contiguous}" if isinstance(a, np.ndarray)
               else type(a).__name__)
        raise ValueError(f"{what}: takes a C-contiguous {np.dtype(dtype)} "
                         f"array of shape {tuple(shape)}, got {got}")
    return ctypes.c_void_p(a.ctypes.data)


def stream(device):
    """PyTorch's current CUDA stream on `device`, as a c_void_p."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
