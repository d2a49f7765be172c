"""The walk stand-in (bench_port/data/walk_analog_1331.264,
tools/gen_walk_stream.py) decoded GOP by GOP on the CPU: a GOP's first
frames, decoded alone from its IDR with the stream's parameter sets in
front, through the per-cell MC route's plain path (_mc_legacy_cells, on
the CPU), against NpDecoder's CRCs of the benchmark's GOP-pass cell
(bench_port/reference/crc/walk_analog_1331.json, tools/gen_walk_crc.py)."""
import json
import os
import zlib

import pytest
import torch

from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native
from losslessh264_tpu_torch import trace
from losslessh264_tpu_torch.parse import split_access_units

native.load()
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = os.path.join(ROOT, "bench_port", "data", "walk_analog_1331.264")
CRCS = os.path.join(ROOT, "bench_port", "reference", "crc",
                    "walk_analog_1331.json")


@pytest.fixture(scope="module")
def walk():
    with open(STREAM, "rb") as fh:
        data = fh.read()
    with open(CRCS) as fh:
        crcs = json.load(fh)
    return split_access_units(data), crcs


def gop_clip(aus, first, frames):
    """Access units first..first+frames-1 behind the stream's SPS and PPS
    (the parameter sets of its first access unit, with start codes)."""
    ps = b"".join(b"\x00\x00\x00\x01" + payload
                  for kind, payload in aus[0][1] if kind in (7, 8))
    return ps + b"".join(raw for raw, _ in aus[first:first + frames])


def test_walk_crcs_hold_the_whole_stream_rows(walk):
    """The GOP-by-GOP CRCs cover the 1331 frames (14 GOPs), and their rows
    equal the JAX package's own NpDecoder (losslessh264_tpu.decoder_np,
    of which the benchmark's reference is a frozen copy) on the stream's
    first two frames decoded whole and on GOP 1's IDR decoded alone."""
    from losslessh264_tpu.decoder_np import NpDecoder
    aus, crcs = walk
    assert crcs["frames"] == len(crcs["crc32"]) == len(aus) == 1331
    assert crcs["gop_starts"] == list(range(0, 1331, 100))
    for first, frames in ((0, 2), (100, 1)):
        got = [zlib.crc32(b"".join(a.tobytes() for a in yuv))
               for yuv in NpDecoder(gop_clip(aus, first, frames)).frames()]
        assert got == crcs["crc32"][first:first + frames]


@pytest.mark.parametrize("first", [100])
def test_walk_gop_decodes_alone_on_cpu(walk, first):
    """GOP 1's IDR and next five P frames, decoded alone, equal NpDecoder's
    frames at their place in the stream; the P frames take the per-cell
    route (dec.mc_cells), whose plain path runs on the CPU."""
    aus, crcs = walk
    assert aus[first][1][0][0] == 5        # the GOP starts at an IDR
    clip = gop_clip(aus, first, 6)
    with trace.recording() as rec:
        got = [zlib.crc32(b"".join(a.numpy().tobytes() for a in yuv))
               for yuv in dt.TorchDecoder(clip, device="cpu").frames()]
    assert got == crcs["crc32"][first:first + 6]
    assert rec.counters["dec.mc_cells"] >= 3
    assert rec.counters["dec.mc_cells_n"] > 0
