"""Annex-B byte streams: NAL units and access-unit boundaries, so that a
clip of the first L frames of a stream is a prefix of its bytes."""
from __future__ import annotations

VCL = (1, 5)   # coded slices: non-IDR and IDR


def nal_units(data: bytes):
    """(start, nal_unit_type, payload offset) of every NAL unit: start is
    the offset of its start code (a 3-byte 00 00 01, with a leading zero
    byte when there is one)."""
    out = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        start = i - 1 if i > 0 and data[i - 1] == 0 else i
        hdr = i + 3
        if hdr < len(data):
            out.append((start, data[hdr] & 0x1F, hdr + 1))
        i = data.find(b"\x00\x00\x01", hdr)
    return out


def access_unit_offsets(data: bytes):
    """Byte offsets at which each access unit starts, then len(data). An
    access unit starts at its first slice with first_mb_in_slice 0 (its
    ue(v) is the single bit 1) or at the non-VCL NAL units (parameter
    sets, SEI, delimiters) just before that slice."""
    offsets = []
    pending = None
    for start, kind, payload in nal_units(data):
        if kind in VCL:
            if payload < len(data) and data[payload] & 0x80:
                offsets.append(pending if pending is not None else start)
            pending = None
        elif pending is None:
            pending = start
    return offsets + [len(data)]


def clip(data: bytes, frames: int, offsets=None) -> bytes:
    """The first `frames` access units of the stream."""
    offsets = offsets or access_unit_offsets(data)
    if not 1 <= frames < len(offsets):
        raise ValueError(f"a clip of {frames} frames of a stream of "
                         f"{len(offsets) - 1}")
    return data[:offsets[frames]]


def clip_lengths(rng, lo, hi):
    """Clip lengths without end: each cycle holds every length lo..hi
    once, in an order drawn from `rng` (a numpy Generator), so every seed
    decodes the same lengths in another order."""
    import numpy as np
    while True:
        yield from (int(x) for x in rng.permutation(np.arange(lo, hi + 1)))
