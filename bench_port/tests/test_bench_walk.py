"""The GOP-pass cell (dec360p_walk_gops) and its driver, decode_gops: the
cell's files load and hold what its configuration states, a GOP's clip
carries the stream's parameter sets and decodes alone, and a fixture cell
of GOP passes at 64x48 runs whole on the CPU: correct when sound, not
correct with the control or a planted fault."""
import json
import os

import numpy as np
import pytest

from conftest import BENCH, ROOT, write_fixture
from harness import frames as gen
from harness import gops, spec, streams
from test_bench_runs import FAULTS, run

CELL = "dec360p_walk_gops"


STREAM = os.path.join(BENCH, "data", "walk_analog_1331.264")
CRCS = os.path.join(BENCH, "reference", "crc", "walk_analog_1331.json")
# walk.264's length and bytes (walk.stats:796-945, SURVEY.md section 6)
WALK_FRAMES, WALK_BYTES = 1331, 8178983


def test_walk_cell_files():
    """The cell's files: its configuration states the stand-in's frames,
    which are walk.264's 1331, and its bytes, which lie within 10% of
    walk.264's (qp 22, the nearest QP: 6.2% fewer); the stream has an IDR
    every 100 frames."""
    c = spec.Cell(ROOT, CELL)
    assert c.driver_name == "decode_gops" and c.chips == 1
    assert (c.config["width"], c.config["height"]) == (640, 352)
    assert c.config["reduced"] == [] and c.config["encoder"]["gop"] == 100
    assert c.traffic["stream"] == "walk_analog_1331"
    with open(STREAM, "rb") as fh:
        data = fh.read()
    assert abs(len(data) / WALK_BYTES - 1) < 0.1
    assert c.config["frames"] == WALK_FRAMES
    assert c.config["bytes"] == len(data)
    starts, n = gops.gop_starts(data)
    assert starts == list(range(0, WALK_FRAMES, 100)) and n == WALK_FRAMES
    assert c.traffic["warmup_gop"] in range(len(starts))
    names = {m["name"] for m in c.per_layer}
    assert {"dec.cells_ms", "dec.cells_roofline", "dec.inter_ms",
            "dec.symbols_ms", "dec.kernel_roofline"} <= names
    assert [m["name"] for m in c.end_to_end] == ["decode_fps", "setup_s"]


def test_walk_crcs_hold_the_committed_rows():
    """NpDecoder's CRCs of all 1331 frames, GOP by GOP; the benchmark's
    frozen NpDecoder gives the first frame of GOPs 0 and 13 (31 frames)
    again."""
    from reference import check as ref, decoder_np
    crcs = json.load(open(CRCS))
    assert crcs["frames"] == len(crcs["crc32"]) == WALK_FRAMES
    assert crcs["gop_starts"] == list(range(0, WALK_FRAMES, 100))
    assert crcs["luma_shape"] == [352, 640]
    with open(STREAM, "rb") as fh:
        data = fh.read()
    for first, clip in (gops.gop_clips(data)[i] for i in (0, 13)):
        yuv = next(iter(decoder_np.NpDecoder(clip).frames()))
        assert ref.frame_crc(*yuv) == crcs["crc32"][first]


def test_gop_clip_carries_its_parameter_sets():
    """Every GOP's clip is the stream's SPS and PPS, then its IDR and its
    P frames; the first GOP's is the stream's own prefix, once; the
    port's symbol layer parses each clip's first frame as an IDR."""
    from losslessh264_tpu_torch import native
    with open(STREAM, "rb") as fh:
        data = fh.read()
    ps = gops.parameter_sets(data)
    assert [k for _, k, _ in streams.nal_units(ps)] == [7, 8]
    clips = gops.gop_clips(data)
    starts = list(range(0, WALK_FRAMES, 100))
    assert [a for a, _ in clips] == starts
    offsets = streams.access_unit_offsets(data)
    for (first, clip), end in zip(clips, starts[1:] + [WALK_FRAMES]):
        kinds = [k for _, k, _ in streams.nal_units(clip)]
        assert kinds == [7, 8, 5] + [1] * (end - first - 1), first
        assert clip == ps + data[offsets[first]:offsets[end]] or (
            first == 0 and clip == data[:offsets[end]])
        f = next(iter(native.SymbolDecoder(clip)))
        assert f["mb_w"] == 40 and f["mb_h"] == 22
        assert bool(np.isin(f["mb_class"], [0, 1, 2, 8]).all()), first


def gop_stream():
    """A 64x48 stream of three GOPs (gop 3: IDRs at frames 0, 3, 6) of the
    port's encoder (CPU) over the seeded pan, and NpDecoder's CRC32 of
    each frame, each GOP decoded alone."""
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    from reference import check as ref, decoder_np
    plan = gen.patch_plan(np.random.default_rng(5), 64, 48, 8, 1)
    enc = TorchEncoder(64, 48, qp=26, gop=3, device="cpu")
    data = b"".join(enc.encode_frame(*f)
                    for f in gen.pan_frames(64, 48, plan, seed=5))
    crcs = []
    for _, clip in gops.gop_clips(data):
        crcs += [ref.frame_crc(*yuv)
                 for yuv in decoder_np.NpDecoder(clip).frames()]
    return data, crcs


@pytest.fixture(scope="module")
def gop_root(tmp_path_factory):
    import torch
    torch.set_num_threads(1)
    data, crcs = gop_stream()
    root = write_fixture(str(tmp_path_factory.mktemp("gops")), data, crcs)
    with open(os.path.join(root, "bench_port", "traffic",
                           "tiny_gop_passes.json"), "w") as fh:
        json.dump({"driver": "decode_gops", "stream": "tiny",
                   "warmup_gop": 1, "trace_frames": 4, "check_share": 0.5},
                  fh)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["workloads"].append({"name": "tiny_gops_dec", "config": "tiny_ippp",
                               "traffic": "tiny_gop_passes", "chips": 1,
                               "why": "fixture"})
    bench["end_to_end"][0]["workloads"].append("tiny_gops_dec")
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return root, data


def test_fixture_gops_stream(gop_root):
    _, data = gop_root
    starts, n = gops.gop_starts(data)
    assert starts == [0, 3, 6] and n == 8


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_fixture_gop_cell(gop_root, fault):
    result, out = run(gop_root[0], "tiny_gops_dec", fault, "cpu")
    assert result["correct"] == (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0
    assert list(result["metrics"]) == ["decode_fps", "setup_s"]


def test_traced_fixture_gop_cell(gop_root):
    """A traced run keeps the spans of decode_closed's labels and the
    program's counters over the window; the work counts are positive."""
    result, out = run(gop_root[0], "tiny_gops_dec", None, "cpu", trace=True)
    assert result["correct"]
    t = out.trace
    assert t.frames > 0 and {"symbols", "plan", "inter"} <= set(t.spans)
    assert t.counters["dec.frames"] >= t.frames
    assert t.least_s > 0 and t.cells_least_s >= 0
