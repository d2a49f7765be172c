"""TorchEncoder (losslessh264_tpu_torch/encoder_torch.py) against
JaxEncoder on the CPU, per option: multiple slices (CAVLC and CABAC),
two reference frames, the in-loop filter on and off, and the
trellis-lite quantizer at a low and a high QP (P8x8 and P16x8/P8x16
partitions and a size that is not a whole number of MBs are in
tests/test_torch_encoder_partitions.py). The recipes are those
of tests/test_encoder_jax.py. Every frame's bytes and recon must equal
JaxEncoder's, and the port's CPU TorchDecoder must decode the port's
bytes to the port's recon (tests/test_torch_encoder.py holds the
default recipes and the helpers)."""
import numpy as np
import pytest

from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.cases import moving_frames

from test_torch_encoder import assert_stream_exact, encode_both

tnative.load()


def _flat_chroma(H, W):
    return (np.full((H // 2, W // 2), 100, np.uint8),
            np.full((H // 2, W // 2), 200, np.uint8))


def _gradient(n=3, H=48, W=64):
    """Smooth luma that the in-loop filter changes at QP 38."""
    yy, xx = np.mgrid[:H, :W]
    return [(((yy * 3 + xx * 2 + i * 7) // 4 % 200 + 20).astype(np.uint8),
             np.full((H // 2, W // 2), 90 + i, np.uint8),
             np.full((H // 2, W // 2), 160, np.uint8)) for i in range(n)]


def _quadrants(seed=11, H=64, W=64):
    """Frame 1's 8x8 quadrants move apart (P8x8)."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, (H * 3, W * 3)).astype(np.uint8)
    f0 = np.ascontiguousarray(bg[:H, :W])
    f1 = f0.copy()
    f1[:H // 2, :W // 2] = bg[2:H // 2 + 2, 3:W // 2 + 3]
    f1[:H // 2, W // 2:] = bg[5:H // 2 + 5, W // 2 - 4:W - 4]
    f1[H // 2:, :W // 2] = bg[H // 2 - 3:H - 3, 1:W // 2 + 1]
    f1[H // 2:, W // 2:] = bg[H // 2 + 6:H + 6, W // 2 + 2:W + 2]
    return [(f, *_flat_chroma(H, W)) for f in (f0, f1)]


def _bands(seed=2, H=64, W=64):
    """Horizontal then vertical bands that move apart (P16x8, P8x16)."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, (H * 3, W * 3)).astype(np.uint8)
    f0 = np.ascontiguousarray(bg[:H, :W])
    fh = f0.copy()
    fh[:8] = bg[3:11, 2:W + 2]
    fh[8:32] = bg[13:37, 1:W + 1]
    fh[32:40] = bg[34:42, 4:W + 4]
    fh[40:] = bg[46:H + 6, 3:W + 3]
    fv = f0.copy()
    fv[:, :8] = bg[2:H + 2, 3:11]
    fv[:, 8:32] = bg[1:H + 1, 13:37]
    fv[:, 32:40] = bg[4:H + 4, 34:42]
    fv[:, 40:] = bg[3:H + 3, 46:W + 6]
    return [(np.ascontiguousarray(f), *_flat_chroma(H, W))
            for f in (f0, fh, fv)]


def _occlusion(seed=4, H=48, W=64):
    """Two pictures alternating: the t-2 reference predicts them."""
    rng = np.random.RandomState(seed)
    A = rng.randint(0, 255, (H, W)).astype(np.uint8)
    B = rng.randint(0, 255, (H, W)).astype(np.uint8)
    return [(Y, *_flat_chroma(H, W)) for Y in (A, A, B, A, B, A)]


def _cropped(seed=3, W=50, H=38):
    """An even size that is not a whole number of MBs (SPS cropping)."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, (H + 32, W + 32)).astype(np.uint8)
    return [(np.ascontiguousarray(bg[i * 2:i * 2 + H, i * 3:i * 3 + W]),
             *_flat_chroma(H, W)) for i in range(3)]


# name: (width, height, frames, options)
RECIPES = {
    "slices3_cavlc": lambda: (64, 96, moving_frames(3, 64, 96),
                              dict(qp=26, slices=3)),
    "slices3_cabac": lambda: (64, 96, moving_frames(3, 64, 96),
                              dict(qp=26, slices=3, cabac=True)),
    "refs2": lambda: (64, 48, _occlusion(), dict(qp=30, refs=2)),
    # the per-MB QP path predicts from one reference whatever refs says,
    # and its IDR's SPS says so (max_num_ref_frames 1)
    "refs2_bgd": lambda: (64, 48, _occlusion(), dict(qp=30, refs=2,
                                                     bgd=True)),
    "deblock_on": lambda: (64, 48, _gradient(), dict(qp=38)),
    "deblock_off": lambda: (64, 48, _gradient(), dict(qp=38, deblock=False)),
    "p8x8": lambda: (64, 64, _quadrants(), dict(qp=30)),
    "p16x8_p8x16": lambda: (64, 64, _bands(), dict(qp=30)),
    "crop_50x38": lambda: (50, 38, _cropped(), dict(qp=28)),
    "trellis_qp26": lambda: (64, 48, moving_frames(4), dict(qp=26,
                                                            trellis=True)),
    "trellis_qp48": lambda: (64, 48, moving_frames(4), dict(qp=48,
                                                            trellis=True)),
}
_RUNS = {}


def run(name):
    if name not in _RUNS:
        W, H, frames, kw = RECIPES[name]()
        _RUNS[name] = encode_both(W, H, frames, **kw)
    return _RUNS[name]


def _classes(data):
    return [(f["mb_class"], f["ref_idx"]) for f in tnative.SymbolDecoder(data)]


# the partition and cropping recipes' streams are in
# tests/test_torch_encoder_partitions.py: two files, so that the tier-1
# run's workers share the compilations
HERE = ("slices3_cavlc", "slices3_cabac", "refs2", "refs2_bgd",
        "deblock_on", "deblock_off", "trellis_qp26", "trellis_qp48")


@pytest.mark.parametrize("name", HERE)
def test_stream_matches_jax(name):
    check_recipe(name)


def check_recipe(name):
    """A recipe's stream is exact (assert_stream_exact) and holds the
    partitions or references the recipe is made to reach."""
    r = run(name)
    assert_stream_exact(r)
    syms = _classes(b"".join(r["torch"]))
    if name == "p8x8":
        assert (syms[1][0] == 6).any()
    elif name == "p16x8_p8x16":
        assert (syms[1][0] == 4).any() and (syms[2][0] == 5).any()
    elif name == "refs2":
        assert (syms[3][1] == 1).any()               # t-2 reference used
        assert len(r["torch"][3]) < len(r["torch"][2]) // 10
    elif name == "refs2_bgd":
        assert all(path == "aq" for _, path, _, _ in r["enc"][1].encodes)


def test_in_loop_filter_changes_the_recon():
    """The filter fires on the gradient at QP 38, so the two runs differ,
    and the trellis rounding changes the coefficients it is asked to."""
    on, off = run("deblock_on"), run("deblock_off")
    assert not np.array_equal(on["torch_recon"][-1][0],
                              off["torch_recon"][-1][0])
    plain = encode_both(64, 48, moving_frames(4), qp=26)
    assert plain["torch"][1:] != run("trellis_qp26")["torch"][1:]
