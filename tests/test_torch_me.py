"""The torch port's motion estimation (losslessh264_tpu_torch/ops/me.py)
and scene-change score (losslessh264_tpu_torch/processing.py) are
element-exact vs the JAX package's (losslessh264_tpu/ops/me.py,
losslessh264_tpu/processing.py) on the CPU.

Every running best of the JAX search keeps its first minimum, so the
flat and periodic planes below, where many displacements or quarter-pel
candidates tie, pin the port's order of visits and its tie-break."""
import numpy as np
import pytest
import torch

from losslessh264_tpu import processing as jproc
from losslessh264_tpu.ops import mc as jmc
from losslessh264_tpu.ops import me as jme
from losslessh264_tpu_torch import processing as tproc
from losslessh264_tpu_torch.ops import me as tme

# one torch thread per test worker (see tests/test_torch_decoder.py)
torch.set_num_threads(1)

PAD = 32


def T(a):
    return torch.as_tensor(np.array(a))


def eq(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def _plane(kind, shape, rng):
    H, W = shape
    if kind == "random":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "flat":
        return np.full(shape, 77, np.uint8)
    # period 4 in x and 2 in y: every 4th horizontal and 2nd vertical
    # shift matches as well as the true one
    yy, xx = np.mgrid[:H, :W]
    return ((xx % 4) * 40 + (yy % 2) * 90 + 10).astype(np.uint8)


def _search_case(kind, radius, seed, H=48, W=64):
    """(cur [H, W] int32, ref_pad [H+2r, W+2r] uint8): cur is the
    reference moved by a few pixels, with noise on the random plane."""
    rng = np.random.default_rng(seed)
    ref = _plane(kind, (H + 8, W + 8), rng)
    cur = ref[3:3 + H, 2:2 + W].astype(np.int32)
    if kind == "random":
        cur = np.clip(cur + rng.integers(-6, 7, cur.shape), 0, 255)
    ref_pad = np.pad(ref[4:4 + H, 4:4 + W], radius, mode="edge")
    return cur, ref_pad


@pytest.mark.parametrize("kind,radius,seed", [
    ("random", 16, 0), ("random", 5, 1), ("flat", 4, 2),
    ("periodic", 6, 3)])
def test_dense_full_search(kind, radius, seed):
    cur, ref_pad = _search_case(kind, radius, seed)
    want = jme.dense_full_search(cur, ref_pad, radius)
    got = tme.dense_full_search(T(cur), T(ref_pad), radius)
    for shape, g3, w3 in zip(("16x16", "16x8", "8x16", "8x8"), got, want):
        for name, g, w in zip(("dy", "dx", "sad"), g3, w3):
            eq(g, w, f"{shape} {name}")
    if kind == "flat":      # every displacement ties: the first one wins
        assert (got[0][0] == -radius).all() and (got[0][1] == -radius).all()


def _quad_case(kind, seed, mb_w=4, mb_h=3):
    """Inputs of subpel_quad as encode_inter_mbs builds them: the K1
    planes of a PAD-padded reference, per 8x8 quadrant its pixel origin,
    an integer MV of |mv| <= 16 px in quarter units (negative half the
    time) and its source block; a random partition per MB."""
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    ref = _plane(kind, (H, W), rng)
    planes = np.asarray(jmc.halfpel_planes(np.pad(ref, PAD, mode="edge")))
    quad = np.arange(4)
    mb = np.arange(n)
    by8 = ((mb // mb_w)[:, None] * 16 + (quad // 2) * 8).reshape(-1)
    bx8 = ((mb % mb_w)[:, None] * 16 + (quad % 2) * 8).reshape(-1)
    mvx = rng.integers(-16, 17, 4 * n) * 4
    mvy = rng.integers(-16, 17, 4 * n) * 4
    if kind == "random":
        src8 = rng.integers(0, 256, (4 * n, 8, 8))
    else:
        src8 = np.stack([ref[y:y + 8, x:x + 8] for y, x in zip(by8, bx8)])
    part = rng.integers(0, 4, n)
    return (planes, by8.astype(np.int32), bx8.astype(np.int32),
            mvx.astype(np.int32), mvy.astype(np.int32),
            src8.astype(np.int32), part.astype(np.int32))


@pytest.mark.parametrize("kind,seed", [("random", 4), ("flat", 5),
                                       ("periodic", 6)])
def test_subpel_quad(kind, seed):
    planes, by8, bx8, mvx, mvy, src8, part = _quad_case(kind, seed)
    want = jme.subpel_quad(planes, PAD, by8, bx8, mvx, mvy, src8, part)
    # the port reads K1's uint8 planes, the JAX function its int32 ones
    for dt in (torch.int32, torch.uint8):
        got = tme.subpel_quad(T(planes).to(dt), PAD, T(by8), T(bx8),
                              T(mvx), T(mvy), T(src8), T(part))
        for name, g, w in zip(("mvqx", "mvqy", "sad", "pred"), got, want):
            eq(g, w, f"{kind} {dt} {name}")


def _refine_case(kind, size, step, seed, mb_w=4, mb_h=3, n=30):
    """Inputs of subpel_refine / subpel_full: the half-pel planes of a
    PAD-padded reference, block origins, MVs in quarter units (integer
    for step 2 and subpel_full, with halves for step 1), a few far
    enough out that the window start is clamped, and source blocks."""
    rng = np.random.default_rng(seed)
    sh, sw = (size, size) if isinstance(size, int) else size
    H, W = mb_h * 16, mb_w * 16
    ref = _plane(kind, (H, W), rng)
    planes = np.asarray(jmc.halfpel_planes(np.pad(ref, PAD, mode="edge")))
    ys = (rng.integers(0, H // sh, n) * sh).astype(np.int32)
    xs = (rng.integers(0, W // sw, n) * sw).astype(np.int32)
    mvx = rng.integers(-16, 17, n) * 4
    mvy = rng.integers(-16, 17, n) * 4
    if step == 1:
        mvx += rng.integers(0, 2, n) * 2
        mvy += rng.integers(0, 2, n) * 2
    mvx[:2] = (4 * (PAD + 12), -4 * (PAD + 20))
    mvy[:2] = (-4 * (PAD + 9), 4 * (PAD + 30))
    if kind == "random":
        src = rng.integers(0, 256, (n, sh, sw))
    else:
        src = np.stack([np.pad(ref, PAD, mode="edge")
                        [PAD + y + 1:PAD + y + 1 + sh, PAD + x:PAD + x + sw]
                        for y, x in zip(ys, xs)])
    return (planes, ys, xs, mvx.astype(np.int32), mvy.astype(np.int32),
            src.astype(np.int32))


@pytest.mark.parametrize("kind,size,step,pred,seed", [
    ("random", 16, 2, False, 20), ("random", 16, 1, True, 21),
    ("periodic", 8, 2, True, 22), ("flat", 16, 1, False, 23),
    ("random", (8, 16), 1, True, 24)])
def test_subpel_refine(kind, size, step, pred, seed):
    planes, ys, xs, mvx, mvy, src = _refine_case(kind, size, step, seed)
    want = jme.subpel_refine(planes, PAD, ys, xs, mvx, mvy, src, step,
                             size=size, return_pred=pred)
    got = tme.subpel_refine(T(planes), PAD, T(ys), T(xs), T(mvx), T(mvy),
                            T(src), step, size=size, return_pred=pred)
    assert len(got) == len(want)
    for name, g, w in zip(("mvx", "mvy", "sad", "pred"), got, want):
        eq(g, w, f"{kind} {size} step {step} {name}")


@pytest.mark.parametrize("kind,size,seed", [
    ("random", 16, 30), ("periodic", 8, 31), ("flat", (16, 8), 32)])
def test_subpel_full(kind, size, seed):
    planes, ys, xs, mvx, mvy, src = _refine_case(kind, size, 2, seed)
    want = jme.subpel_full(planes, PAD, ys, xs, mvx, mvy, src, size=size)
    got = tme.subpel_full(T(planes), PAD, T(ys), T(xs), T(mvx), T(mvy),
                          T(src), size=size)
    for name, g, w in zip(("mvx", "mvy", "sad", "pred"), got, want):
        eq(g, w, f"{kind} {size} {name}")


def test_intra_sad_proxy():
    rng = np.random.default_rng(7)
    mbs = rng.integers(0, 256, (40, 16, 16)).astype(np.int32)
    mbs[:4] = 200                              # flat MBs: SAD 0
    mbs[4] = np.arange(256).reshape(16, 16)    # mean rounds at .5
    eq(tme.intra_sad_proxy(T(mbs)), jme.intra_sad_proxy(mbs))


def _scene_pair(n_over, n_blocks=(4, 5), over=321):
    """(cur, ref) of 8x8-block luma where the first n_over blocks have a
    zero-MV SAD of `over` and the others of exactly the threshold (320,
    not above it)."""
    bh, bw = n_blocks
    ref = np.full((8 * bh, 8 * bw), 100, np.uint8)
    cur = ref + 5                              # SAD 64 * 5 = 320 per block
    for k in range(n_over):
        y, x = divmod(k, bw)
        cur[8 * y, 8 * x] += over - 320
    return cur.astype(np.uint8), ref


@pytest.mark.parametrize("n_over", [0, 9, 10, 11, 16, 17, 18, 20])
def test_scene_change_score_at_thresholds(n_over):
    """Out of 20 blocks, 10 is 0.5 and 17 is 0.85 exactly (the MEDIUM and
    LARGE ratios): the float32 score and its classification must agree
    with JAX's float32 mean."""
    cur, ref = _scene_pair(n_over)
    want = jproc.scene_change_score(cur, ref)
    got = tproc.scene_change_score(T(cur), T(ref))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    for ratio in (tproc.SCENE_CHANGE_RATIO_LARGE,
                  tproc.SCENE_CHANGE_RATIO_MEDIUM):
        assert (float(got) > ratio) == (float(want) > ratio)


def test_scene_change_score_random():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (720, 1280)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-12, 13, a.shape), 0,
                255).astype(np.uint8)
    for cur, ref in ((a, b), (a, a), (a, rng.permutation(a))):
        want = jproc.scene_change_score(cur, ref)
        got = tproc.scene_change_score(T(cur), T(ref))
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_pinned_constants():
    for name in ("HIGH_MOTION_BLOCK_THRESHOLD", "SCENE_CHANGE_RATIO_LARGE",
                 "SCENE_CHANGE_RATIO_MEDIUM"):
        assert getattr(tproc, name) == getattr(jproc, name), name
