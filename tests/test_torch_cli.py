"""The port's pinned copies of parse.py and checkpoint.py, and its CLI's
recompression verbs (losslessh264_tpu_torch/__main__.py), equal the JAX
package's on the CPU: the same parsed access units, the same segment
files and containers, and the same output files and printed lines as
losslessh264_tpu.__main__.main on the same arguments (compress,
decompress, roundtrip, parse, --shards, --billing, --stats,
--no-verify)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from losslessh264_tpu import __main__ as jmain
from losslessh264_tpu import checkpoint as jckpt
from losslessh264_tpu import parse as jparse
from losslessh264_tpu_torch import __main__ as tmain
from losslessh264_tpu_torch import checkpoint as tckpt
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch import parse as tparse
from losslessh264_tpu_torch.encoder_torch import encode_yuv

tnative.load()
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
STREAMS = {"walk": os.path.join(DATA, "walk_analog.264"),
           "ltr": os.path.join(DATA, "ltr_gap_64x48.264")}
LTR = STREAMS["ltr"]


@pytest.fixture(scope="module")
def gop2_stream():
    """The recipe of tests/test_checkpoint.py: 8 frames of 64x48 panning
    noise at gop 2 (4 IDR segments), from the port's TorchEncoder on the
    CPU, whose bytes equal JaxEncoder's."""
    rng = np.random.RandomState(9)
    H, W = 48, 64
    bg = rng.randint(0, 255, (H + 64, W + 64)).astype(np.uint8)
    frames = [(np.ascontiguousarray(bg[i * 4:i * 4 + H, i * 5:i * 5 + W]),
               np.full((H // 2, W // 2), 100, np.uint8),
               np.full((H // 2, W // 2), 60, np.uint8)) for i in range(8)]
    return encode_yuv(frames, W, H, qp=28, gop=2, device="cpu")


@pytest.mark.parametrize("which", ["ltr", "gop2"])
def test_parse_matches_jax(which, gop2_stream):
    data = open(LTR, "rb").read() if which == "ltr" else gop2_stream
    assert tparse.split_access_units(data) == \
        jparse.split_access_units(data)
    assert tparse._split_nals(data) == jparse._split_nals(data)
    got = list(tparse.DecodeParser(data))
    want = list(jparse.DecodeParser(data))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        for k in ("annexb", "nals", "is_idr", "width", "height", "mb_w",
                  "mb_h"):
            assert getattr(g, k) == getattr(w, k), k
        assert g.reassembled() == w.reassembled()
        assert g.symbols.keys() == w.symbols.keys()
        for k, v in w.symbols.items():
            np.testing.assert_array_equal(np.asarray(g.symbols[k]),
                                          np.asarray(v), err_msg=k)
    assert tparse.DecodeParser(data).sps_pps() == \
        jparse.DecodeParser(data).sps_pps()
    # the parse contract: the concatenated AUs decode to the same symbols
    joined = b"".join(au.annexb for au in got)
    for g, w in zip(tnative.SymbolDecoder(joined),
                    tnative.SymbolDecoder(data)):
        np.testing.assert_array_equal(g["mb_class"], w["mb_class"])


def test_checkpoint_matches_jax(gop2_stream, tmp_path):
    """tests/test_checkpoint.py's resume and corruption recipes; the
    segment files and the container equal the JAX copy's."""
    data = gop2_stream
    assert tckpt.segment_ranges(data) == jckpt.segment_ranges(data)
    starts = tnative.gop_starts(data)
    assert starts[0] == 0 and len(starts) == 4
    for a in starts[1:]:
        assert tckpt._context_before(data, a) == \
            jckpt._context_before(data, a)
    cc = tckpt.CheckpointedCompressor(data, str(tmp_path / "t"))
    assert len(cc.ranges) == 4
    assert cc.run(max_segments=2) == 2
    assert len(cc.pending()) == 2
    with pytest.raises(RuntimeError):
        cc.assemble()
    cc2 = tckpt.CheckpointedCompressor(data, str(tmp_path / "t"))
    assert len(cc2.pending()) == 2
    assert cc2.run() == 2
    pip = cc2.assemble()
    jc = jckpt.CheckpointedCompressor(data, str(tmp_path / "j"))
    jc.run()
    assert pip == jc.assemble()
    for i in range(4):
        assert (open(cc2._seg_path(i), "rb").read()
                == open(jc._seg_path(i), "rb").read())
    assert tnative.decompress(pip)[0] == data
    assert cc2.run() == 0
    # a truncated segment is found and redone
    p = cc2._seg_path(1)
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[: len(blob) // 2])
    assert cc2.pending() == [1]
    assert tckpt._segment_done(p, data[slice(*cc2.ranges[1])]) == \
        jckpt._segment_done(p, data[slice(*cc2.ranges[1])])
    cc2.run()
    assert tnative.decompress(cc2.assemble())[0] == data


_FPS = re.compile(r"\d+\.\d fps")


def _run_both(capsys, args):
    """main(args) of both CLIs; returns their (rc, stdout, stderr), fps
    figures masked (they are timings)."""
    out = []
    for main in (tmain.main, jmain.main):
        rc = main(list(args))
        cap = capsys.readouterr()
        out.append((rc, _FPS.sub("<fps>", cap.out),
                    _FPS.sub("<fps>", cap.err)))
    return out


@pytest.mark.parametrize("name,flags", [
    ("ltr", ["--stats"]), ("ltr", ["--no-verify", "--billing"]),
    ("walk", ["--shards", "4", "--stats", "--billing"])])
def test_compress_decompress_match_jax(capsys, tmp_path, name, flags):
    src = STREAMS[name]
    t_pip, j_pip = tmp_path / "t.pip", tmp_path / "j.pip"
    got = tmain.main([src, str(t_pip)] + flags)
    t_out = capsys.readouterr()
    want = jmain.main([src, str(j_pip)] + flags)
    j_out = capsys.readouterr()
    assert (got, t_out.out, t_out.err) == (want, j_out.out, j_out.err)
    assert t_pip.read_bytes() == j_pip.read_bytes()
    if "--shards" in flags:
        assert t_pip.read_bytes()[:4] == b"PIPS"
    if "--billing" in flags:
        assert "TOTAL" in t_out.out
    # decompress by magic, through both CLIs
    t_264, j_264 = tmp_path / "t.264", tmp_path / "j.264"
    outs = []
    for main, dst in ((tmain.main, t_264), (jmain.main, j_264)):
        outs.append((main([str(t_pip), str(dst), "--stats", "--billing"]),
                     capsys.readouterr()))
    assert outs[0][0] == outs[1][0] == 0
    assert outs[0][1].out == outs[1][1].out
    assert outs[0][1].err == outs[1][1].err
    assert t_264.read_bytes() == j_264.read_bytes() == \
        open(src, "rb").read()


@pytest.mark.parametrize("args", [
    ["roundtrip", "ltr"], ["roundtrip", "ltr", "--billing"],
    ["roundtrip", "walk", "--shards", "4"], ["parse", "ltr"]])
def test_roundtrip_and_parse_match_jax(capsys, args):
    args = [args[0], STREAMS[args[1]]] + args[2:]
    (rc_t, out_t, err_t), (rc_j, out_j, err_j) = _run_both(capsys, args)
    assert (rc_t, out_t, err_t) == (rc_j, out_j, err_j)
    assert rc_t == 0
    if args[0] == "roundtrip":
        assert "bit-exact: YES" in out_t
    else:
        assert out_t.endswith("24 access units\n")


def test_cli_subprocess(tmp_path):
    """The module runs as `python -m losslessh264_tpu_torch`."""
    dst = tmp_path / "w.pip"
    subprocess.run([sys.executable, "-m", "losslessh264_tpu_torch", LTR,
                    str(dst), "--shards", "2"], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    assert dst.read_bytes() == tnative.compress_sharded(
        open(LTR, "rb").read(), 2, verify=True)[0]
