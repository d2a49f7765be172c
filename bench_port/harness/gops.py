"""GOPs of an Annex-B stream: where each starts (an access unit whose
slices are IDR slices) and a clip of one GOP that decodes alone, with the
stream's parameter sets in front, as a player that seeks to an IDR or a
GOP-sharded worker hands it to a decoder."""
from __future__ import annotations

from . import streams

PARAMETER_SETS = (7, 8)   # SPS, PPS
IDR = 5


def parameter_sets(data: bytes) -> bytes:
    """Every SPS and PPS NAL unit of the stream, start codes included, in
    stream order."""
    units = streams.nal_units(data)
    ends = [s for s, _, _ in units[1:]] + [len(data)]
    return b"".join(data[s:e] for (s, kind, _), e in zip(units, ends)
                    if kind in PARAMETER_SETS)


def gop_starts(data: bytes, offsets=None):
    """The access-unit indices at which a GOP starts (its IDR), ascending,
    and the stream's access-unit count."""
    offsets = offsets or streams.access_unit_offsets(data)
    starts = []
    units = streams.nal_units(data)
    k = 0
    for start, kind, _ in units:
        while k + 1 < len(offsets) and start >= offsets[k + 1]:
            k += 1
        if kind == IDR and (not starts or starts[-1] != k):
            starts.append(k)
    return starts, len(offsets) - 1


def gop_clip(data: bytes, first: int, end: int, offsets=None,
             ps: bytes | None = None) -> bytes:
    """Access units first..end-1 (first an IDR's) as a stream of their
    own: the parameter sets, then the units' bytes. A clip that starts
    with a parameter set already (the stream's first GOP) is returned as
    it is."""
    offsets = offsets or streams.access_unit_offsets(data)
    body = data[offsets[first]:offsets[end]]
    lead = streams.nal_units(body[:64])
    if lead and lead[0][1] in PARAMETER_SETS:
        return body
    return (parameter_sets(data) if ps is None else ps) + body


def gop_clips(data: bytes):
    """[(first frame, clip bytes)] of every GOP of the stream."""
    offsets = streams.access_unit_offsets(data)
    starts, n = gop_starts(data, offsets)
    ps = parameter_sets(data)
    ends = starts[1:] + [n]
    return [(a, gop_clip(data, a, b, offsets, ps))
            for a, b in zip(starts, ends)]
