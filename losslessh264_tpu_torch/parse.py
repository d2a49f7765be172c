"""Parse-only decode API (a pinned copy of losslessh264_tpu/parse.py
over the port's native binding; tests/test_torch_cli.py holds it to the
original): the reference's ISVCDecoder::DecodeParser shape
(codec_api.h:416-437) — parse an Annex-B stream WITHOUT pixel
reconstruction and hand back, per access unit, the re-assembled NAL
units (normalized 4-byte start codes) plus the parsed symbol planes.

The reference's parse-only mode feeds packetizers/transcoders that need
the bitstream re-framed and the headers understood but never touch
pixels (SPsPpsInfo + re-assembled frame NALs in SParserBsInfo). Here
the symbol layer (native.SymbolDecoder) does the header/slice parse,
and the AU splitter groups the input's NAL byte spans to frames.

Contract (tested in tests/test_parse_api.py): concatenating every
yielded AU's `annexb` round-trips the stream — feeding it to a fresh
SymbolDecoder yields identical symbol planes.
"""
from __future__ import annotations

from . import native

_VCL = {1, 2, 3, 4, 5}


def _split_nals(data: bytes):
    """[(start_code_pos, payload_start, payload_end)] for every NAL."""
    out = []
    i = 0
    n = len(data)
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        sc = j
        if sc > 0 and data[sc - 1] == 0:
            sc -= 1                      # 4-byte start code
        k = data.find(b"\x00\x00\x01", j + 3)
        end = n if k < 0 else (k - 1 if data[k - 1] == 0 else k)
        # trailing zeros before the next start code beyond the one the
        # 4-byte prefix consumes belong to this NAL (cabac_zero_words)
        out.append((sc, j + 3, end))
        if k < 0:
            break
        i = j + 3
    return out


def _first_mb_is_zero(payload: bytes) -> bool:
    """True iff the slice header's first_mb_in_slice ue(v) == 0, i.e.
    the first bit after the NAL header byte is 1."""
    if len(payload) < 2:
        return False
    return bool(payload[1] & 0x80)


def split_access_units(data: bytes):
    """Group a stream's NALs into access units (7.4.1.2.3 simplified:
    a VCL NAL with first_mb_in_slice == 0 starts a new AU; leading
    non-VCL NALs attach to the AU they precede). Returns a list of
    (au_bytes, nal_list) with nal_list = [(type, payload_bytes)]."""
    spans = _split_nals(data)
    aus = []
    cur = []          # [(sc, ps, pe, type)]
    cur_has_vcl = False
    for (sc, ps, pe) in spans:
        t = data[ps] & 0x1f
        is_vcl = t in _VCL
        starts_new = (is_vcl and cur_has_vcl
                      and _first_mb_is_zero(data[ps:ps + 2]))
        if (is_vcl or t in (6, 7, 8, 9, 10, 11)) and starts_new:
            aus.append(cur)
            cur = []
            cur_has_vcl = False
        if not is_vcl and cur_has_vcl:
            # non-VCL after this AU's slices opens the next AU
            aus.append(cur)
            cur = []
            cur_has_vcl = False
        cur.append((sc, ps, pe, t))
        cur_has_vcl = cur_has_vcl or is_vcl
    if cur:
        aus.append(cur)
    out = []
    for au in aus:
        raw = data[au[0][0]:au[-1][2]]
        nals = [(t, data[ps:pe]) for (sc, ps, pe, t) in au]
        out.append((raw, nals))
    return out


class ParsedAU:
    """One parsed access unit (no reconstruction)."""

    __slots__ = ("annexb", "nals", "is_idr", "width", "height",
                 "mb_w", "mb_h", "symbols")

    def __init__(self, raw, nals, symbols):
        self.annexb = raw               # exact input byte span
        self.nals = nals                # [(nal_type, payload bytes)]
        self.symbols = symbols          # full symbol-plane dict
        self.is_idr = bool(symbols["is_idr"])
        self.mb_w = int(symbols["mb_w"])
        self.mb_h = int(symbols["mb_h"])
        cl, cr, ct, cb = symbols.get("crop_px", (0, 0, 0, 0))
        self.width = self.mb_w * 16 - cl - cr
        self.height = self.mb_h * 16 - ct - cb

    def reassembled(self) -> bytes:
        """NALs re-framed with normalized 4-byte start codes (the
        reference DecodeParser's dst-buffer framing)."""
        return b"".join(b"\x00\x00\x00\x01" + p for _, p in self.nals)


class DecodeParser:
    """Parse-only decoder: iterate ParsedAU per access unit.

    No pixel pipeline runs — only the native symbol layer's header and
    entropy parse (native/src/decsupport.cc), making this the
    lightweight transport/inspection path the reference exposes as
    DecodeParser."""

    def __init__(self, data: bytes):
        self._data = bytes(data)
        self._aus = split_access_units(self._data)

    def __iter__(self):
        sym = iter(native.SymbolDecoder(self._data))
        # AUs carrying VCL data map 1:1 to symbol frames in order;
        # leading parameter-set-only AUs (if any) attach forward
        pending = []
        for raw, nals in self._aus:
            if not any(t in _VCL for t, _ in nals):
                pending.append((raw, nals))
                continue
            f = next(sym)
            if pending:
                raw = b"".join(p[0] for p in pending) + raw
                nals = [x for p in pending for x in p[1]] + nals
                pending = []
            yield ParsedAU(raw, nals, f)

    def sps_pps(self):
        """All parameter-set NAL payloads in stream order (the
        reference's SpsPpsInfo half of the parse-only API)."""
        return [(t, p) for _, nals in self._aus for t, p in nals
                if t in (7, 8, 13, 15)]
