"""The port's pinned copies equal their originals: every table and
function of losslessh264_tpu_torch/ref_np.py against
losslessh264_tpu/decoder_np.py, and the port's SymbolDecoder
(losslessh264_tpu_torch/native.py) against losslessh264_tpu.native's on
real frames. Exact equality throughout; no JAX is imported."""
import os

import numpy as np
import pytest

from losslessh264_tpu import decoder_np as dn
from losslessh264_tpu import native as jnative
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch import ref_np

DATA = os.path.join(os.path.dirname(__file__), "data")


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("mine,orig", [
    ("CHROMA_QP", "CHROMA_QP"), ("V4", "_V4"), ("POS4", "_POS4"),
    ("V8", "_V8"), ("POS8", "_POS8"), ("ZZ4", "_ZZ4"), ("ZZ8", "_ZZ8"),
    ("ALPHA_TABLE", "ALPHA_TABLE"), ("BETA_TABLE", "BETA_TABLE"),
    ("TC0_TABLE", "TC0_TABLE")])
def test_table(mine, orig):
    _same(getattr(ref_np, mine), getattr(dn, orig), mine)


def test_scaling_weights():
    rng = np.random.default_rng(0)
    for _ in range(4):
        r4 = rng.integers(1, 256, 16, dtype=np.uint8)
        r8 = rng.integers(1, 256, 64, dtype=np.uint8)
        _same(ref_np.weights4(r4), dn._weights4(r4), "weights4")
        _same(ref_np.weights8(r8), dn._weights8(r8), "weights8")


@pytest.mark.parametrize("crop", [(0, 0, 0, 0), (0, 0, 0, 8), (2, 4, 6, 8)])
def test_crop_yuv(crop):
    rng = np.random.default_rng(1)
    yuv = (rng.integers(0, 256, (48, 64), dtype=np.uint8),
           rng.integers(0, 256, (24, 32), dtype=np.uint8),
           rng.integers(0, 256, (24, 32), dtype=np.uint8))
    for g, w in zip(ref_np.crop_yuv(yuv, crop), dn.crop_yuv(yuv, crop)):
        _same(g, w, str(crop))


def test_mc_blocks():
    """Every quarter-pel (luma) and eighth-pel (chroma) phase, and MVs far
    enough out that the reference's clip engages."""
    rng = np.random.default_rng(2)
    ry = rng.integers(0, 256, (48 + 8, 64 + 8), dtype=np.uint8)
    rc = rng.integers(0, 256, (24 + 8, 32 + 8), dtype=np.uint8)
    for mvx in list(range(-4, 5)) + [-400, 333]:
        for mvy in list(range(-4, 5)) + [-250, 301]:
            for y0, x0 in ((0, 0), (16, 32), (32, 48)):
                _same(ref_np.mc_luma_block(ry, 4, y0, x0, mvx, mvy, 16, 16),
                      dn.mc_luma_block(ry, 4, y0, x0, mvx, mvy, 16, 16),
                      f"luma {y0} {x0} {mvx} {mvy}")
                _same(ref_np.mc_chroma_block(rc, 4, y0 // 2, x0 // 2, mvx,
                                             mvy, 8, 8),
                      dn.mc_chroma_block(rc, 4, y0 // 2, x0 // 2, mvx, mvy,
                                         8, 8),
                      f"chroma {y0} {x0} {mvx} {mvy}")


def _damaged_frame(seed, is_idr, mv_offset):
    """A 6x4-MB frame with about a third of its MBs undecoded, random
    classes, partition corners, ref_idx and MVs (the symbol planes
    concealment reads)."""
    rng = np.random.default_rng(seed)
    mb_w, mb_h = 6, 4
    n = mb_w * mb_h
    f = {"mb_w": mb_w, "mb_h": mb_h, "is_idr": is_idr,
         "decoded": (rng.random(n) > 0.35).astype(np.uint8),
         "mb_class": rng.integers(0, 12, n).astype(np.uint8),
         "part_tl": (rng.random((n, 16)) > 0.5).astype(np.uint8),
         "ref_idx": rng.integers(-1, 3, (n, 16)).astype(np.int8),
         "mv": (rng.integers(-40, 41, (n, 16, 2))
                + np.asarray(mv_offset)).astype(np.int16)}
    yuv = tuple(rng.integers(0, 256, s, dtype=np.uint8)
                for s in ((64, 96), (32, 48), (32, 48)))
    prev = tuple(rng.integers(0, 256, s, dtype=np.uint8)
                 for s in ((64, 96), (32, 48), (32, 48)))
    return f, yuv, prev


@pytest.mark.parametrize("ec_mode", ["mv_copy_freeze", "slice_copy"])
@pytest.mark.parametrize("case", ["mv", "mv_scaled", "mv_clamped", "idr",
                                  "no_prev"])
def test_conceal_undecoded(ec_mode, case):
    prev_idx = 7
    f, yuv, prev = _damaged_frame(
        3 + len(case), case == "idr",
        (-500, 300) if case == "mv_clamped" else (5, -3))
    f["ref_list"] = [prev_idx - 2 if case == "mv_scaled" else prev_idx]
    if case == "no_prev":
        prev = None
    want = dn.conceal_undecoded(f, yuv, prev, prev_idx, ec_mode)
    got = ref_np.conceal_undecoded(f, yuv, prev, prev_idx, ec_mode)
    for g, w, pl in zip(got, want, "YUV"):
        _same(g, w, f"{ec_mode} {case} {pl}")
    assert not np.array_equal(got[0], yuv[0])   # some MB was concealed


def test_symbol_decoder_walk_analog():
    """Frames 0-2 of walk_analog.264: every plane and scalar the port's
    SymbolDecoder yields equals the JAX package's."""
    with open(os.path.join(DATA, "walk_analog.264"), "rb") as fh:
        data = fh.read()
    mine, orig = tnative.SymbolDecoder(data), jnative.SymbolDecoder(data)
    for i in range(3):
        g, w = next(mine), next(orig)
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                _same(g[k], w[k], f"frame {i} {k}")
            else:
                assert g[k] == w[k], f"frame {i} {k}"
