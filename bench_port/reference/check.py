"""The reference's side of every comparison that decides `correct`."""
from __future__ import annotations

import json
import zlib

import numpy as np

from . import decoder_np, symbols


def stream_crcs(path):
    """NpDecoder's per-frame CRC32s of a benchmark stream (a file of crc/,
    recorded with the numpy decoder over every frame of the stream)."""
    with open(path) as fh:
        return json.load(fh)["crc32"]


def frame_crc(Y, U, V):
    """CRC32 of Y|U|V as NpDecoder's table has it (uncropped uint8 planes)."""
    return zlib.crc32(np.ascontiguousarray(Y).tobytes()
                      + np.ascontiguousarray(U).tobytes()
                      + np.ascontiguousarray(V).tobytes())


def parse(data, keep=()):
    """Run the symbol layer over a whole stream: (frames, damaged frames,
    {index: symbol planes} of the frames in `keep`). A stream the layer
    cannot parse to its end counts its remaining frames as missing, which
    the caller sees as fewer frames."""
    n, damaged, kept = 0, 0, {}
    try:
        for f in symbols.SymbolDecoder(data):
            if f.get("lost_slices", 0) or not bool(f["decoded"].all()):
                damaged += 1
            if n in keep:
                kept[n] = f
            n += 1
    except RuntimeError:
        damaged += 1
    return n, damaged, kept


def recon(f, picture):
    """The numpy decoder's reconstruction of the frame with symbol planes
    `f`, before output cropping, reading each reference picture it names
    by output index from `picture(i)` -> (Y, U, V) uint8 numpy. Pictures
    it does not name are left out (NpDecoder pads every earlier output;
    here only the named ones are real)."""
    rf = f["ref_frame"]
    named = sorted(set(int(x) for x in np.unique(rf[rf >= 0])))
    tiny = (np.zeros((1, 1), np.uint8),) * 3
    outputs = [tiny] * ((named[-1] + 1) if named else 0)
    for i in named:
        outputs[i] = tuple(np.ascontiguousarray(a) for a in picture(i))
    dec = decoder_np.NpDecoder.__new__(decoder_np.NpDecoder)
    dec.outputs = outputs
    return dec._recon_frame(f)


def mismatched(a, b):
    """Samples that differ between two (Y, U, V) pictures; a shape that
    differs counts every sample of `a`."""
    n = 0
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        n += int(x.size) if x.shape != y.shape else int((x != y).sum())
    return n


def mse(picture, source):
    """Mean squared error of the luma of `picture` against `source`'s."""
    d = np.asarray(picture[0], np.float64) - np.asarray(source[0],
                                                        np.float64)
    return float((d * d).mean())
