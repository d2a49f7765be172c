"""The port's ctypes binding of the shared native library (native/).

`native/libh264pip.so` is the repo's C++ layer: Annex-B parsing,
CAVLC/CABAC entropy decode into per-frame symbol planes, the lossless
recompressor and its `.pip` container. The port uses the streaming
`SymbolDecoder` (native/src/capi_sym.cc) for the pixel decode, and the
recompressor's entry points (`compress`, `compress_sharded`,
`decompress`, the GOP cut points and shard plan) for its CLI, its GOP
sharding (parallel/) and checkpointing. This module is the port's own
copy of losslessh264_tpu/native.py's binding, so the port imports
nothing of the JAX package; tests pin it to the original.

The library is built by `make -C native` at first use, with the
Makefile's own compiler (`CXX=g++`: an inherited CXX may name a compiler
whose LTO plugin cannot run the Makefile's -flto link). Several
processes may load at once (test workers, a decode beside a test), and a
`make` that runs in two of them, or a `dlopen` of a library that another
process is still linking, fails ("file too short"). So `load()` checks
and builds only while it holds an exclusive flock on build/native.lock,
and opens the library after it has released the lock.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from dataclasses import dataclass

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_ROOT, "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libh264pip.so")
LOCK_PATH = os.path.join(_ROOT, "build", "native.lock")

_lib = None


class PipStats(ctypes.Structure):
    """The C entry points' statistics record (native/src/capi.cc)."""
    _fields_ = [
        ("in_bytes", ctypes.c_uint64),
        ("out_bytes", ctypes.c_uint64),
        ("n_nals", ctypes.c_uint64),
        ("n_slices", ctypes.c_uint64),
        ("n_fallback_slices", ctypes.c_uint64),
        ("n_frames", ctypes.c_uint64),
        ("n_mbs", ctypes.c_uint64),
        ("bill", ctypes.c_double * 64),
        ("bench", ctypes.c_double * 64),
        ("prior_total", ctypes.c_double * 64),
        ("prior_hits", ctypes.c_double * 64),
    ]


# Mirrors BillTag in native/src/engine.h (order matters).
BILL_NAMES = [
    "mb_type", "skip", "end", "cbp", "cbp_luma", "cbp_chroma", "qp_delta",
    "i4_mode", "i8_mode", "i16_mode", "chroma_mode", "sub_mb", "ref_idx",
    "mvd_x", "mvd_y", "t8x8_flag", "luma_dc", "chroma_dc", "luma_nz",
    "luma_ac", "luma_run", "chroma_nz", "chroma_ac", "chroma_run", "pcm",
    "startcode", "nal_hdr", "param_set", "slice_hdr", "trailing",
    "raw_fallback", "container", "other", "luma_ac_sign", "luma_ac_mag",
    "cabac_cbf", "cabac_sig", "cabac_last", "cabac_sign",
    "mvd_sub_x", "mvd_sub_y", "chroma_ac_sign", "chroma_ac_mag",
]


@dataclass
class Stats:
    in_bytes: int = 0
    out_bytes: int = 0
    n_nals: int = 0
    n_slices: int = 0
    n_fallback_slices: int = 0
    n_frames: int = 0
    n_mbs: int = 0
    # compressed output bits per feature; sums to 8 * out_bytes
    bill: dict | None = None
    # bits the original H.264 spent per feature; sums to 8 * in_bytes
    bench: dict | None = None
    # per-feature adaptive-coder hit rates (PIP_PRIOR_STATS=1):
    # tag -> (decisions, predicted-symbol hits)
    prior: dict | None = None


def needs_rebuild() -> bool:
    """True when the library is missing or a native/src source (.cc,
    .h) is newer than it: the rule losslessh264_tpu/native.py applies."""
    if not os.path.exists(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    src = os.path.join(NATIVE_DIR, "src")
    return any(os.path.getmtime(os.path.join(src, f)) > t
               for f in os.listdir(src) if f.endswith((".cc", ".h")))


def _build_locked():
    os.makedirs(os.path.dirname(LOCK_PATH), exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if needs_rebuild():
                res = subprocess.run(
                    ["make", "-C", NATIVE_DIR, "-j", str(os.cpu_count() or 4)],
                    capture_output=True, text=True,
                    env=dict(os.environ, CXX="g++"))
                if res.returncode != 0:
                    raise RuntimeError("make -C native failed:\n"
                                       + res.stdout + res.stderr)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load():
    """The loaded native library, built first (under the lock) when it
    is missing or older than its sources."""
    global _lib
    if _lib is None:
        _build_locked()
        lib = ctypes.CDLL(LIB_PATH)
        lib.pip_sym_open.restype = ctypes.c_void_p
        lib.pip_sym_open.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ctypes.c_size_t]
        lib.pip_sym_next.restype = ctypes.c_int
        lib.pip_sym_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_size_t]
        lib.pip_sym_planes.restype = ctypes.c_int
        lib.pip_sym_planes.argtypes = [ctypes.c_void_p] * 32
        lib.pip_sym_close.restype = None
        lib.pip_sym_close.argtypes = [ctypes.c_void_p]
        _configure_pip(lib)
        _lib = lib
    return _lib


def _configure_pip(lib):
    """Signatures of the recompressor's C entry points."""
    c = ctypes
    out = [c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_size_t),
           c.POINTER(PipStats), c.c_char_p, c.c_size_t]
    sigs = {
        "pip_compress_c": [c.c_char_p, c.c_size_t, c.c_int] + out,
        "pip_compress_ctx_c": [c.c_char_p, c.c_size_t, c.c_char_p,
                               c.c_size_t, c.c_int] + out,
        "pip_decompress_c": [c.c_char_p, c.c_size_t] + out,
        "pip_compress_sharded_c": [c.c_char_p, c.c_size_t, c.c_int,
                                   c.c_int] + out,
        "pip_selftest_arith": [c.c_char_p, c.c_size_t],
        "pip_gop_starts_c": [c.c_char_p, c.c_size_t,
                             c.POINTER(c.c_uint64), c.c_size_t,
                             c.POINTER(c.c_size_t), c.c_char_p,
                             c.c_size_t],
        "pip_shard_plan_c": [c.c_char_p, c.c_size_t, c.c_int,
                             c.POINTER(c.c_uint64), c.POINTER(c.c_uint64),
                             c.POINTER(c.c_uint64), c.c_char_p, c.c_size_t,
                             c.c_size_t, c.POINTER(c.c_size_t), c.c_char_p,
                             c.c_size_t],
        "pip_version_c": [],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = c.c_int
    lib.pip_free.argtypes = [c.POINTER(c.c_uint8)]
    lib.pip_free.restype = None


def container_version() -> int:
    """The native engine's .pip format/model revision byte, which
    Python-side container assemblers (checkpoint, GOP shard assembly)
    write."""
    return int(load().pip_version_c())


def _stats_from(c: PipStats) -> Stats:
    names = range(len(BILL_NAMES))
    bill = {BILL_NAMES[i]: c.bill[i] for i in names if c.bill[i] > 0}
    bench = {BILL_NAMES[i]: c.bench[i] for i in names if c.bench[i] > 0}
    prior = {BILL_NAMES[i]: (c.prior_total[i], c.prior_hits[i])
             for i in names if c.prior_total[i] > 0}
    return Stats(
        in_bytes=c.in_bytes, out_bytes=c.out_bytes, n_nals=c.n_nals,
        n_slices=c.n_slices, n_fallback_slices=c.n_fallback_slices,
        n_frames=c.n_frames, n_mbs=c.n_mbs, bill=bill,
        bench=bench or None, prior=prior or None)


def _call_out(what, fn, *args):
    """Call a C entry point that returns a malloc'd buffer and stats;
    returns (bytes, Stats) and frees the buffer."""
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_size_t()
    st = PipStats()
    err = ctypes.create_string_buffer(1024)
    rc = fn(*args, ctypes.byref(out), ctypes.byref(out_size),
            ctypes.byref(st), err, len(err))
    if rc != 0:
        raise RuntimeError(f"{what} failed: {err.value.decode()}")
    try:
        return ctypes.string_at(out, out_size.value), _stats_from(st)
    finally:
        load().pip_free(out)


def gop_starts(data: bytes) -> list[int]:
    """Byte offsets of GOP (IDR access-unit) segment starts."""
    cap = 65536
    buf = (ctypes.c_uint64 * cap)()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(512)
    rc = load().pip_gop_starts_c(data, len(data), buf, cap, ctypes.byref(n),
                                 err, len(err))
    if rc != 0:
        raise RuntimeError(f"pip_gop_starts failed: {err.value.decode()}")
    return [int(buf[i]) for i in range(min(n.value, cap))]


def shard_plan(data: bytes, n_shards: int) -> list[tuple[int, int, bytes]]:
    """The shard decomposition compress_sharded uses: [(start, end,
    sps_pps_context_bytes), ...], whole-GOP groups balanced by bytes.
    The native planner can return more shards than `n_shards` (on
    walk_analog.264: 3, 4, 5 and 10 for 2, 3, 4 and 8), so callers size
    by len(plan), as the JAX package's do."""
    cap = 4096
    starts = (ctypes.c_uint64 * cap)()
    ends = (ctypes.c_uint64 * cap)()
    ctx_lens = (ctypes.c_uint64 * cap)()
    ctx_cap = 1 << 22
    ctx_buf = ctypes.create_string_buffer(ctx_cap)
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(512)
    rc = load().pip_shard_plan_c(data, len(data), n_shards, starts, ends,
                                 ctx_lens, ctx_buf, ctx_cap, cap,
                                 ctypes.byref(n), err, len(err))
    if rc != 0:
        raise RuntimeError(f"pip_shard_plan failed: {err.value.decode()}")
    out = []
    off = 0
    for i in range(n.value):
        clen = int(ctx_lens[i])
        out.append((int(starts[i]), int(ends[i]), ctx_buf.raw[off:off + clen]))
        off += clen
    return out


def compress(data: bytes, verify: bool = True,
             context: bytes = b"") -> tuple[bytes, Stats]:
    """Compress an Annex-B .264 stream to the .pip container.

    context: an optional SPS/PPS NAL stream absorbed for parameter-set
    state but not emitted (GOP segment or checkpoint compression)."""
    lib = load()
    if context:
        return _call_out("pip_compress", lib.pip_compress_ctx_c, data,
                         len(data), context, len(context),
                         1 if verify else 0)
    return _call_out("pip_compress", lib.pip_compress_c, data, len(data),
                     1 if verify else 0)


def compress_sharded(data: bytes, n_shards: int,
                     verify: bool = False) -> tuple[bytes, Stats]:
    """GOP-sharded compression on the native engine's threads (shards
    are model-independent: the multi-host distribution unit)."""
    return _call_out("pip_compress_sharded", load().pip_compress_sharded_c,
                     data, len(data), n_shards, 1 if verify else 0)


def decompress(data: bytes) -> tuple[bytes, Stats]:
    """Reconstruct the original .264 byte stream from a .pip container."""
    return _call_out("pip_decompress", load().pip_decompress_c, data,
                     len(data))


def selftest_arith() -> None:
    """The native arithmetic coder's self-test; raises on failure."""
    err = ctypes.create_string_buffer(1024)
    rc = load().pip_selftest_arith(err, len(err))
    if rc != 0:
        raise RuntimeError(f"arith selftest failed: {err.value.decode()}")


class SymbolDecoder:
    """Streaming symbol-plane decoder: parses a .264 and yields one dict
    of numpy planes per frame (native/src/decsupport.cc). A copy of
    losslessh264_tpu.native.SymbolDecoder; a test pins the two."""

    def __init__(self, data: bytes):
        self._lib = load()
        err = ctypes.create_string_buffer(512)
        self._h = self._lib.pip_sym_open(data, len(data), err, len(err))
        if not self._h:
            raise RuntimeError(f"pip_sym_open failed: {err.value.decode()}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pip_sym_close(self._h)
            self._h = None

    def __iter__(self):
        return self

    def __next__(self):
        w = ctypes.c_int()
        h = ctypes.c_int()
        err = ctypes.create_string_buffer(512)
        rc = self._lib.pip_sym_next(self._h, ctypes.byref(w), ctypes.byref(h),
                                    err, len(err))
        if rc == 0:
            raise StopIteration
        if rc < 0:
            raise RuntimeError(f"pip_sym_next failed: {err.value.decode()}")
        n = w.value * h.value
        f = {
            "mb_w": w.value,
            "mb_h": h.value,
            "mb_class": np.zeros(n, np.uint8),
            "qp": np.zeros(n, np.uint8),
            "cbp_luma": np.zeros(n, np.uint8),
            "cbp_chroma": np.zeros(n, np.uint8),
            "transform8": np.zeros(n, np.uint8),
            "i16_mode": np.zeros(n, np.uint8),
            "chroma_mode": np.zeros(n, np.uint8),
            "i4_modes": np.zeros((n, 16), np.int8),
            "luma_ac": np.zeros((n, 16, 4, 4), np.int16),
            "luma_dc": np.zeros((n, 4, 4), np.int16),
            "luma8": np.zeros((n, 4, 8, 8), np.int16),
            "chroma_ac": np.zeros((n, 8, 4, 4), np.int16),
            "chroma_dc": np.zeros((n, 2, 2, 2), np.int16),
            "mv": np.zeros((n, 16, 2), np.int16),
            "ref_frame": np.zeros((n, 16), np.int16),
            "pcm": np.zeros((n, 384), np.uint8),
            "slice_id": np.zeros(n, np.uint8),
            "deblock_idc": np.zeros(n, np.uint8),
            "alpha_off": np.zeros(n, np.int8),
            "beta_off": np.zeros(n, np.int8),
            # weighted prediction: per luma cell (w, o, log2denom); denom
            # -1 = unweighted. wp_cmask: per chroma pixel (8x8/MB), the
            # reference's quarter-size weighting region.
            "wp_luma": np.zeros((n, 16, 3), np.int16),
            "wp_cb": np.zeros((n, 16, 3), np.int16),
            "wp_cr": np.zeros((n, 16, 3), np.int16),
            "wp_cmask": np.zeros((n, 8, 8), np.uint8),
            # raw ref_idx per cell (-1 intra); deblock bS compares these
            # (reference semantics), not resolved output frames
            "ref_idx": np.zeros((n, 16), np.int8),
            "decoded": np.zeros(n, np.uint8),
            # 1 at the top-left cell of each motion partition: the
            # sample set MV-copy error concealment averages over
            "part_tl": np.zeros((n, 16), np.uint8),
        }
        meta = np.zeros(12, np.int32)
        scaling = np.zeros(96 + 384, np.uint8)
        ref_list = np.zeros(19, np.int32)
        dpb_live = np.zeros(18, np.int32)

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p)

        rc = self._lib.pip_sym_planes(
            self._h, ptr(f["mb_class"]), ptr(f["qp"]), ptr(f["cbp_luma"]),
            ptr(f["cbp_chroma"]), ptr(f["transform8"]), ptr(f["i16_mode"]),
            ptr(f["chroma_mode"]), ptr(f["i4_modes"]), ptr(f["luma_ac"]),
            ptr(f["luma_dc"]), ptr(f["luma8"]), ptr(f["chroma_ac"]),
            ptr(f["chroma_dc"]), ptr(f["mv"]), ptr(f["ref_frame"]),
            ptr(f["pcm"]), ptr(f["slice_id"]), ptr(f["deblock_idc"]),
            ptr(f["alpha_off"]), ptr(f["beta_off"]), ptr(meta), ptr(scaling),
            ptr(f["wp_luma"]), ptr(f["wp_cb"]), ptr(f["wp_cr"]),
            ptr(f["wp_cmask"]), ptr(f["ref_idx"]), ptr(f["decoded"]),
            ptr(f["part_tl"]), ptr(ref_list), ptr(dpb_live),
        )
        if rc != 0:
            raise RuntimeError("pip_sym_planes failed")
        # frame-level L0 ref list (ref_idx -> output index)
        f["ref_list"] = ref_list[1:1 + int(ref_list[0])].tolist()
        # full post-marking DPB (eviction liveness, long-term pictures
        # outside the active L0 range included)
        f["dpb_live"] = dpb_live[1:1 + int(dpb_live[0])].tolist()
        f["use_scaling"] = bool(meta[0])
        f["chroma_qp_offset"] = int(meta[1])
        f["second_chroma_qp_offset"] = int(meta[2])
        f["is_ref"] = bool(meta[3])
        f["is_idr"] = bool(meta[4])
        f["constrained_intra"] = bool(meta[5])
        # SPS frame cropping in luma samples (4:2:0 frame_mbs_only:
        # CropUnitX = CropUnitY = 2, spec 7.4.2.1.1)
        f["crop_px"] = tuple(int(meta[6 + i]) * 2 for i in range(4))
        f["lost_slices"] = int(meta[10])
        f["scaling4"] = scaling[:96].reshape(6, 16)
        f["scaling8"] = scaling[96:].reshape(6, 64)
        return f
