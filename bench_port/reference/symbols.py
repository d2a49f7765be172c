"""The symbol layer the reference decoder reads: a ctypes binding of the
shared C++ parse layer's streaming symbol-plane decoder
(native/src/decsupport.cc, built as native/libh264pip.so).

A frozen copy of losslessh264_tpu_torch/native.SymbolDecoder and of the
four signatures its `load` sets, so that the reference imports nothing
of the program under test. It never builds the library: the program's
set-up builds it under the checkout (make -C native) before any check
runs, and a missing library is an error here.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "libh264pip.so")

_lib = None


def load():
    """The parse layer's library, opened once with the symbol entries'
    signatures."""
    global _lib
    if _lib is None:
        if not os.path.exists(LIB_PATH):
            raise RuntimeError(f"{LIB_PATH} is not built")
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
        _lib = lib
    return _lib


class SymbolDecoder:
    """Streaming symbol-plane decoder: parses a .264 and yields one dict
    of numpy planes per frame (native/src/decsupport.cc)."""

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
