"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

The sources are compiled by nvcc into one shared library with a plain C
interface, build/kernels/libpip_kernels.so under the checkout, and
loaded with ctypes. Each C entry point takes device pointers, sizes and
the CUDA stream, launches on that stream, and returns
cudaGetLastError(); `check` raises when that is not 0. The library is
rebuilt only when a source is newer than it. Nothing here runs at
import: the CPU tests import every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libpip_kernels.so")
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC"]
# one source (or the objects) straight to a shared library
NVCC_FLAGS = COMPILE_FLAGS + ["-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (all return int, a cudaError_t)
_SIGNATURES = {
    # (src, dst, Hp, Wp, stream)
    "pip_halfpel_i32": [_P, _P, _I, _I, _P],
    # (src, dst, Hp, Wp, pitch, stream)
    "pip_halfpel_u8_pitched": [_P, _P, _I, _I, _I, _P],
    # (Y, U, V, y_stride, c_stride, params, sync scratch [1 + 2*mb_h],
    #  mb_w, mb_h, stream)
    "pip_deblock_frame": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P],
}

_lib = None
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


def _nvcc():
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def needs_build():
    if not os.path.exists(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > t for s in sources())


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
            so = ctypes.CDLL(LIB_PATH)
            for name, args in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = so
    return _lib


def stream(device):
    """PyTorch's current CUDA stream on `device`, as a c_void_p."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
