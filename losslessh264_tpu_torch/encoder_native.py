"""The encoder's binding of the shared native writer (native/).

`pip_encode_frame` (native/src/encode_api.cc) assembles one frame's
slices from per-MB symbol planes with the same CAVLC / CABAC writers the
recompression path uses, and `pip_encode_mv_preds` returns the motion
vector predictors the writer will use, from which the encoder decides
P_Skip. These are pinned copies of losslessh264_tpu/encoder.py's
`_cfg_lib` and `_write_frame` and of the `pip_encode_mv_preds` call of
`JaxEncoder._mv_preds`, on the port's own loader (native.load), so the
port imports nothing of the JAX package; tests/test_torch_encoder.py
holds them to the originals on the same arrays.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import native


def cfg_lib():
    """The native library with the encoder entry points' signatures."""
    lib = native.load()
    if not hasattr(lib.pip_encode_frame, "_cfg"):
        lib.pip_encode_frame.restype = ctypes.c_int
        lib.pip_encode_frame.argtypes = [ctypes.c_int] * 6 + \
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + \
            [ctypes.c_void_p] * 4 + \
            [ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
             ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
             ctypes.c_size_t]
        lib.pip_encode_mv_preds.restype = ctypes.c_int
        lib.pip_encode_mv_preds.argtypes = [ctypes.c_int] * 3 + \
            [ctypes.c_void_p] * 7 + [ctypes.c_char_p, ctypes.c_size_t]
        lib.pip_encode_frame._cfg = True
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def write_frame(lib, mw, mh, qp, frame_idx, slice_type, mb_class, mv,
                i16_mode, chroma_mode, i4_modes, luma_dc, luma_ac,
                chroma_dc, chroma_ac, include_params, mb_qp=None,
                cabac=False, n_slices=1, mv8=None, deblock_idc=1,
                out_qp=None, crop_r=0, crop_b=0, is_ref=True,
                frame_num=None, idr_id=0, ltr_flags=0, n_refs=1,
                ref_plane=None, sps_refs=0, rplr_diff=0,
                mmco_drops=None, param_id=0, row_slice=None,
                out_row_bits=None):
    """One frame's Annex-B bytes from its symbol planes (host numpy)."""
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(512)
    mv16 = np.ascontiguousarray(mv, np.int16)
    luma_ac16 = np.ascontiguousarray(luma_ac, np.int16)
    chroma_ac16 = np.ascontiguousarray(chroma_ac, np.int16)
    luma_dc16 = np.ascontiguousarray(luma_dc, np.int16)
    chroma_dc16 = np.ascontiguousarray(chroma_dc, np.int16)
    if mb_qp is not None:
        mb_qp = np.ascontiguousarray(mb_qp, np.uint8)
    if mv8 is not None:
        mv8 = np.ascontiguousarray(mv8, np.int16)
    if ref_plane is not None:
        ref_plane = np.ascontiguousarray(ref_plane, np.int8)
    if frame_num is None:
        frame_num = frame_idx
    mmco_arr = (None if mmco_drops is None or not len(mmco_drops)
                else np.ascontiguousarray(mmco_drops, np.intc))
    if row_slice is not None:
        row_slice = np.ascontiguousarray(row_slice, np.intc)
    if out_row_bits is not None:
        assert (out_row_bits.dtype == np.uint32
                and out_row_bits.flags["C_CONTIGUOUS"])
    rc = lib.pip_encode_frame(
        mw, mh, qp, frame_num, idr_id & 1, slice_type,
        _ptr(mb_class), _ptr(mv16), _ptr(i16_mode), _ptr(chroma_mode),
        _ptr(i4_modes), _ptr(luma_dc16), _ptr(luma_ac16), _ptr(chroma_dc16),
        _ptr(chroma_ac16), None if mb_qp is None else _ptr(mb_qp),
        None if mv8 is None else _ptr(mv8),
        1 if include_params else 0, 1 if cabac else 0, int(n_slices),
        int(deblock_idc), int(crop_r), int(crop_b), 1 if is_ref else 0,
        int(ltr_flags), int(n_refs), int(sps_refs), int(rplr_diff),
        None if mmco_arr is None else _ptr(mmco_arr),
        0 if mmco_arr is None else len(mmco_arr), int(param_id),
        None if ref_plane is None else _ptr(ref_plane),
        None if row_slice is None else _ptr(row_slice),
        None if out_row_bits is None else _ptr(out_row_bits),
        None if out_qp is None else _ptr(out_qp),
        ctypes.byref(out), ctypes.byref(out_size), err, len(err))
    if rc != 0:
        raise RuntimeError(f"pip_encode_frame: {err.value.decode()}")
    try:
        return ctypes.string_at(out, out_size.value)
    finally:
        lib.pip_free(out)


def mv_preds(lib, mb_w, mb_h, n_slices, mb_class, mv, mv8=None,
             ref_plane=None, row_slice=None):
    """(skip_pred, p16_pred) [n, 2] int16: the P_Skip and P16x16 motion
    vector predictors of every MB under the final classes, with slices of
    whole MB rows in equal shares, or by the row plan `row_slice` ([mb_h]
    slice index per MB row) of size-capped slices."""
    n = mb_w * mb_h
    skip_pred = np.zeros((n, 2), np.int16)
    p16_pred = np.zeros((n, 2), np.int16)
    err = ctypes.create_string_buffer(512)
    mv16 = np.ascontiguousarray(mv, np.int16)
    mbc = np.ascontiguousarray(mb_class, np.uint8)
    if mv8 is not None:
        mv8 = np.ascontiguousarray(mv8, np.int16)
    if ref_plane is not None:
        ref_plane = np.ascontiguousarray(ref_plane, np.int8)
    if row_slice is not None:
        row_slice = np.ascontiguousarray(row_slice, np.intc)
    rc = lib.pip_encode_mv_preds(
        mb_w, mb_h, n_slices, None if row_slice is None else _ptr(row_slice),
        _ptr(mbc),
        _ptr(mv16), None if mv8 is None else _ptr(mv8),
        None if ref_plane is None else _ptr(ref_plane),
        _ptr(skip_pred), _ptr(p16_pred), err, len(err))
    if rc != 0:
        raise RuntimeError(f"pip_encode_mv_preds: {err.value.decode()}")
    return skip_pred, p16_pred
