"""Checkpoint/resume for long compression jobs (a pinned copy of
losslessh264_tpu/checkpoint.py over the port's native binding;
tests/test_torch_cli.py holds it to the original).

The reference has no checkpointing (SURVEY.md §5.4: its only durable
artifact is the finished .pip). Here the resumable state is explicit:
the input splits at GOP (IDR) boundaries — exactly the cut points GOP
sharding uses — and every segment compresses to a fully self-contained
`.pip` (the container embeds the SPS/PPS context and the segment CRC).
A killed job resumes by validating finished segment files against the
source bytes and re-running only the missing ones; `assemble()` emits
the standard sharded container (`PIPS`), decodable by `decompress()`.
"""
from __future__ import annotations

import os

from . import native


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7


def _crc32_ieee(data: bytes) -> int:
    import zlib
    return zlib.crc32(data) & 0xFFFFFFFF


def segment_ranges(data: bytes) -> list[tuple[int, int]]:
    """GOP segment byte ranges [(start, end), ...] (native cut points)."""
    starts = native.gop_starts(data)
    return [(starts[i], starts[i + 1] if i + 1 < len(starts) else len(data))
            for i in range(len(starts))]


def _context_before(data: bytes, end: int) -> bytes:
    """All SPS/PPS NAL bytes (with start codes) before byte offset `end`
    — the same accumulation the native sharder performs."""
    out = bytearray()
    i = 0
    while True:
        j = data.find(b"\x00\x00\x01", i, end)
        if j < 0 or j + 3 >= end:
            break
        # NAL extent: up to the next start code (minus its leading zeros)
        k = data.find(b"\x00\x00\x01", j + 3)
        if k < 0:
            k = len(data)
        else:
            while k > j + 3 and data[k - 1] == 0:
                k -= 1
        if (data[j + 3] & 0x1F) in (7, 8):
            s = j
            while s > 0 and data[s - 1] == 0:
                s -= 1
            out += data[s:min(k, end)]
        i = j + 3
    return bytes(out)


def _segment_done(path: str, seg: bytes) -> bool:
    """A finished segment file is valid iff its embedded original size
    and CRC match the source bytes AND the container structure walks to
    exactly the file end (catches truncation without decompressing)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return False
    if blob[:4] != b"PIPT" or len(blob) < 6:
        return False
    try:
        size, pos = _read_varint(blob, 5)
        crc, pos = _read_varint(blob, pos)
        if size != len(seg) or crc != _crc32_ieee(seg):
            return False
        ctx_len, pos = _read_varint(blob, pos)
        pos += ctx_len
        def_len, pos = _read_varint(blob, pos)
        pos += def_len
        n_streams, pos = _read_varint(blob, pos)
        if n_streams > 256:
            return False
        for _ in range(n_streams):
            _tag, pos = _read_varint(blob, pos)
            slen, pos = _read_varint(blob, pos)
            pos += slen
        return pos == len(blob)
    except IndexError:
        return False


class CheckpointedCompressor:
    """Compress `data` segment by segment into `workdir`, resumably.

    run() is idempotent: segments whose files already validate are
    skipped, so re-running after a crash continues where it stopped.
    """

    def __init__(self, data: bytes, workdir: str, verify: bool = False):
        self.data = data
        self.workdir = workdir
        self.verify = verify
        os.makedirs(workdir, exist_ok=True)
        self.ranges = segment_ranges(data)

    def _seg_path(self, i: int) -> str:
        return os.path.join(self.workdir, f"seg{i:05d}.pip")

    def pending(self) -> list[int]:
        return [i for i, (a, b) in enumerate(self.ranges)
                if not _segment_done(self._seg_path(i), self.data[a:b])]

    def run(self, max_segments: int | None = None) -> int:
        """Compress up to max_segments pending segments; returns how many
        were completed this call."""
        done = 0
        for i in self.pending():
            if max_segments is not None and done >= max_segments:
                break
            a, b = self.ranges[i]
            ctx = _context_before(self.data, a) if a > 0 else b""
            pip, _ = native.compress(self.data[a:b], verify=self.verify,
                                     context=ctx)
            tmp = self._seg_path(i) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(pip)
            os.replace(tmp, self._seg_path(i))  # atomic commit
            done += 1
        return done

    def assemble(self) -> bytes:
        """Concatenate finished segments into the standard sharded (PIPS)
        container. Raises if any segment is missing/invalid."""
        missing = self.pending()
        if missing:
            raise RuntimeError(f"segments not finished: {missing[:8]}")
        payloads = [open(self._seg_path(i), "rb").read()
                    for i in range(len(self.ranges))]
        if len(payloads) == 1:
            return payloads[0]
        out = bytearray(b"PIPS") + bytes([native.container_version()])
        out += _varint(len(self.data))
        out += _varint(_crc32_ieee(self.data))
        out += _varint(len(payloads))
        for p in payloads:
            out += _varint(len(p))
        for p in payloads:
            out += p
        return bytes(out)
