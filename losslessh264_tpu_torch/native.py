"""The port's ctypes binding of the shared native library (native/).

`native/libh264pip.so` is the repo's C++ layer: Annex-B parsing,
CAVLC/CABAC entropy decode into per-frame symbol planes, the lossless
recompressor and its `.pip` container. The port uses the streaming
`SymbolDecoder` (native/src/decsupport.h) through a handle of its own
that keeps the parse's planes (csrc/sym_planes.cpp), parsed ahead on a
native thread (csrc/sym_ahead.cpp), for the pixel decode, and the
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
import functools
import os
import subprocess
from dataclasses import dataclass

import numpy as np

from . import _build, trace

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


# pip_pooled_planes' (and pip_sym_planes') buffers in their argument
# order: (name, dtype, shape, per MB: the shape after the MB count, else
# the whole shape). meta,
# scaling, ref_list and dpb_live are read into the frame dict; the rest
# are its per-MB planes.
_SYM_BUFFERS = (
    ("mb_class", np.uint8, (), True),
    ("qp", np.uint8, (), True),
    ("cbp_luma", np.uint8, (), True),
    ("cbp_chroma", np.uint8, (), True),
    ("transform8", np.uint8, (), True),
    ("i16_mode", np.uint8, (), True),
    ("chroma_mode", np.uint8, (), True),
    ("i4_modes", np.int8, (16,), True),
    ("luma_ac", np.int16, (16, 4, 4), True),
    ("luma_dc", np.int16, (4, 4), True),
    ("luma8", np.int16, (4, 8, 8), True),
    ("chroma_ac", np.int16, (8, 4, 4), True),
    ("chroma_dc", np.int16, (2, 2, 2), True),
    ("mv", np.int16, (16, 2), True),
    ("ref_frame", np.int16, (16,), True),
    ("pcm", np.uint8, (384,), True),
    ("slice_id", np.uint8, (), True),
    ("deblock_idc", np.uint8, (), True),
    ("alpha_off", np.int8, (), True),
    ("beta_off", np.int8, (), True),
    ("meta", np.int32, (12,), False),
    ("scaling", np.uint8, (96 + 384,), False),
    # weighted prediction: per luma cell (w, o, log2denom); denom -1 =
    # unweighted. wp_cmask: per chroma pixel (8x8/MB), the reference's
    # quarter-size weighting region.
    ("wp_luma", np.int16, (16, 3), True),
    ("wp_cb", np.int16, (16, 3), True),
    ("wp_cr", np.int16, (16, 3), True),
    ("wp_cmask", np.uint8, (8, 8), True),
    # raw ref_idx per cell (-1 intra); deblock bS compares these
    # (reference semantics), not resolved output frames
    ("ref_idx", np.int8, (16,), True),
    ("decoded", np.uint8, (), True),
    # 1 at the top-left cell of each motion partition: the sample set
    # MV-copy error concealment averages over
    ("part_tl", np.uint8, (16,), True),
    ("ref_list", np.int32, (19,), False),
    ("dpb_live", np.int32, (18,), False),
)


def _nbytes(dtype, shape):
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


# the buffers' sizes for the parse-ahead worker: [bytes per MB, then
# fixed bytes] of each, in _SYM_BUFFERS' order
_SYM_SIZES = np.array(
    [[_nbytes(d, s) if per_mb else 0 for _, d, s, per_mb in _SYM_BUFFERS],
     [0 if per_mb else _nbytes(d, s) for _, d, s, per_mb in _SYM_BUFFERS]],
    np.int64)


@functools.lru_cache(maxsize=8)
def _sym_layout(n):
    """The buffers of an n-MB frame inside one allocation, as
    csrc/sym_ahead.cpp lays them out: (its bytes, the buffers' own bytes,
    ((name, dtype, shape, byte offset), ...) in pip_sym_planes' order,
    each at a 64-byte boundary)."""
    out, off, own = [], 0, 0
    for name, dtype, shape, per_mb in _SYM_BUFFERS:
        shape = (n,) + shape if per_mb else shape
        nbytes = _nbytes(dtype, shape)
        out.append((name, np.dtype(dtype), shape, off))
        off += -(-nbytes // 64) * 64
        own += nbytes
    return off, own, tuple(out)


@functools.lru_cache(maxsize=8)
def _block_type(size):
    """The ctypes type of a `size`-byte frame buffer of the parse-ahead
    worker: the arrays over one keep it alive, and the last to go hands
    it back to the worker's library (pip_ahead_free)."""
    free, addressof = _build.host_lib().pip_ahead_free, ctypes.addressof

    class Block(ctypes.c_uint8 * size):
        def __del__(self):
            free(addressof(self), size)
    return Block


def _frame(w, h, ptr, size):
    """The frame dict over a worker's buffer at `ptr`: its per-MB planes
    are views of the buffer, and the rest is read from it."""
    total, own, layout = _sym_layout(w * h)
    if size != total:
        raise RuntimeError(f"parse-ahead buffer of {size} bytes, the "
                           f"layout's is {total}")
    raw = np.frombuffer(_block_type(size).from_address(ptr), np.uint8)
    if trace.on():
        trace.count("dec.symbol_bytes", own)
    f = {"mb_w": w, "mb_h": h}
    view = np.ndarray
    for name, dtype, shape, off in layout:
        f[name] = view(shape, dtype, raw, off)
    # the buffers that are not planes, read into the dict's other keys
    meta = f.pop("meta").tolist()
    scaling = f.pop("scaling")
    ref_list = f.pop("ref_list").tolist()
    dpb_live = f.pop("dpb_live").tolist()
    # frame-level L0 ref list (ref_idx -> output index)
    f["ref_list"] = ref_list[1:1 + ref_list[0]]
    # full post-marking DPB (eviction liveness, long-term pictures
    # outside the active L0 range included)
    f["dpb_live"] = dpb_live[1:1 + dpb_live[0]]
    f["use_scaling"] = bool(meta[0])
    f["chroma_qp_offset"] = meta[1]
    f["second_chroma_qp_offset"] = meta[2]
    f["is_ref"] = bool(meta[3])
    f["is_idr"] = bool(meta[4])
    f["constrained_intra"] = bool(meta[5])
    # SPS frame cropping in luma samples (4:2:0 frame_mbs_only:
    # CropUnitX = CropUnitY = 2, spec 7.4.2.1.1)
    f["crop_px"] = tuple(meta[6 + i] * 2 for i in range(4))
    f["lost_slices"] = meta[10]
    f["scaling4"] = scaling[:96].reshape(6, 16)
    f["scaling8"] = scaling[96:].reshape(6, 64)
    return f


def _sym_functions(lib):
    """The addresses of the host library's pip_pooled_next,
    pip_pooled_planes and pip_pooled_close, which the parse-ahead worker
    calls."""
    return [ctypes.cast(getattr(lib, name), ctypes.c_void_p).value
            for name in ("pip_pooled_next", "pip_pooled_planes",
                         "pip_pooled_close")]


# pip_ahead_take's results (csrc/sym_ahead.cpp)
_NOT_READY, _FRAME, _END, _NEXT_FAILED, _PLANES_FAILED = 2, 1, 0, -1, -2


class SymbolDecoder:
    """Streaming symbol-plane decoder: parses a .264 and yields one dict
    of numpy planes per frame (native/src/decsupport.cc). It yields what
    losslessh264_tpu.native.SymbolDecoder yields, frame for frame; a
    test pins the two.

    The handle (csrc/sym_planes.cpp) parses every frame into one set of
    planes that it takes from a process-wide pool and hands back when it
    closes, so their memory is reused across frames and decoders. The
    parse runs ahead on a native worker thread of its own
    (csrc/sym_ahead.cpp), started by the first `__next__`: a decoder
    never iterated starts none. The worker runs the parse,
    pip_pooled_next, and the planes' copy-out, pip_pooled_planes, up to
    `_DEPTH` frames ahead of the consumer while the consumer plans and
    issues the frames before, and
    never takes the interpreter lock. `__next__` takes the next frame's
    buffer and makes its dict (the per-MB planes are views of the
    buffer, freed with the last of them); it raises StopIteration at the
    end, and the native layer's RuntimeError after the frames parsed
    before it, as the serial parse did. A decoder dropped mid-stream
    stops its worker, which closes the handle once it has left the
    native calls for good.

    Traced, `__next__` records the worker's steps as the worker's spans
    (`dec.symbols.parse`, `.alloc`, `.export`, timed there), its wait
    for a frame the worker has not finished as `dec.symbols.wait`, and
    each frame that was ready as `dec.symbols_ahead`, each frame parsed
    into planes that held as large a frame before as
    `dec.symbols_planes_kept`, and the worker's minor page faults during
    the parse as `dec.symbols_faults`.
    """

    # frames parsed ahead: a 720p frame's buffer is ~8 MB
    _DEPTH = 3

    def __init__(self, data: bytes):
        self._lib = _build.host_lib()
        err = ctypes.create_string_buffer(512)
        self._h = self._lib.pip_pooled_open(data, len(data), err, len(err))
        if not self._h:
            raise RuntimeError(f"pip_sym_open failed: {err.value.decode()}")
        self._ahead = None
        self._done = False

    def __del__(self):
        if getattr(self, "_ahead", None):
            # the worker closes the handle
            self._lib.pip_ahead_stop(self._ahead)
        elif getattr(self, "_h", None):
            self._lib.pip_pooled_close(self._h)
        self._ahead = self._h = None

    def __iter__(self):
        return self

    def _start(self):
        ahead = ctypes.c_void_p()
        if self._lib.pip_ahead_start(self._h, *_sym_functions(self._lib),
                                     self._DEPTH, _SYM_SIZES.ctypes.data,
                                     ctypes.byref(ahead)) != 0:
            raise RuntimeError("pip_ahead_start failed: no worker thread")
        self._ahead, self._h = ahead.value, None
        self._out = np.zeros(11, np.int64)
        self._err = ctypes.create_string_buffer(512)
        # pip_ahead_take's arguments after `block`
        self._take_args = (self._out.ctypes.data, self._err, len(self._err))

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._ahead is None:
            self._start()
        take = self._lib.pip_ahead_take
        rc = take(self._ahead, 0, *self._take_args)
        if rc == _NOT_READY:
            with trace.span("dec.symbols.wait"):
                rc = take(self._ahead, 1, *self._take_args)
        elif rc == _FRAME:
            trace.count("dec.symbols_ahead")
        (w, h, ptr, size, t0, t1, t2, t3, thread, kept,
         faults) = self._out.tolist()
        if trace.on():
            trace.add_span("dec.symbols.parse", t0, t1, thread)
            if rc == _FRAME:
                trace.add_span("dec.symbols.alloc", t1, t2, thread)
                trace.add_span("dec.symbols.export", t2, t3, thread)
                trace.count("dec.symbols_planes_kept", kept)
                trace.count("dec.symbols_faults", faults)
        if rc == _FRAME:
            return _frame(w, h, ptr, size)
        self._done = True
        if rc == _END:
            raise StopIteration
        if rc == _NEXT_FAILED:
            raise RuntimeError(
                f"pip_sym_next failed: {self._err.value.decode()}")
        if rc == _PLANES_FAILED:
            raise RuntimeError("pip_sym_planes failed")
        raise MemoryError("no memory for a frame's symbol planes")
