"""The port's processing.py and its pinned ratectl.py copy against the JAX
package on the CPU, on the same seeded numpy inputs:

- every processing function: VAA, the scene score, the AQ delta-QP plane
  and its mean (many seeds at 64x48 and 720p, with content built to put
  the float32 model near integer dQP, and at 1080p), the down/upsampler
  and pyramid, complexity, background mask, scroll detection (720p and
  64x96), denoise and rotation;
- the float32 sums in XLA CPU's order (`_xla_sum_all`, `_xla_sum_rows`);
- every rate controller of ratectl.py driven through the same call
  sequences (tick, should_skip, frame_qp with every scene_idc, gom_dqp,
  update, report_delivery): equal outputs and equal state.

Everything is exact: the AQ plane equal as int8, its mean and the scroll
costs equal as float32."""
import jax
import numpy as np
import pytest
import torch

from losslessh264_tpu import processing as jp
from losslessh264_tpu import ratectl as jrc
from losslessh264_tpu_torch import processing as tp
from losslessh264_tpu_torch import ratectl as trc

from test_torch_encoder import eq


def T(a):
    return torch.as_tensor(np.asarray(a))


def _pair(H, W, seed):
    """(cur, ref) luma of one of four kinds of content."""
    rng = np.random.RandomState(seed)
    kind = seed % 4
    if kind == 0:       # noise against noise
        a = rng.randint(0, 256, (H, W))
        b = rng.randint(0, 256, (H, W))
    elif kind == 1:     # a noisy ramp, moved
        yy, xx = np.mgrid[:H, :W]
        a = (yy * (seed % 7 + 1) + xx * 3 + rng.randint(0, 40, (H, W))) % 256
        b = np.roll(a, seed % 5, 1)
    elif kind == 2:     # flat half and textured half, moved down
        a = rng.randint(0, 256, (H, W))
        a[:, :W // 2] //= 8
        b = np.roll(a, 2, 0)
    else:               # smooth noise and a dimmed copy
        a = np.clip(rng.normal(128, 10 + seed, (H, W)), 0, 255)
        b = a * 0.9 + 5
    return a.astype(np.uint8), b.astype(np.uint8)


def _boundary_pair(H, W, seed, trials=300):
    """MBs whose top and bottom halves are checkerboards of amplitudes d1
    and d2 around 128 (texture index exactly (d1^2 + d2^2) // 2) and a
    static reference: of `trials` random amplitude plans, the one whose
    float64 dQP comes nearest an integer in some MB."""
    rng = np.random.RandomState(seed)
    mh, mw = H // 16, W // 16
    yy, xx = np.mgrid[:16, :16]
    sign = np.where((yy + xx) % 2, 1, -1)
    gain, alpha = 5.8185, 0.991
    best, best_d = None, 1.0
    for _ in range(trials):
        d = rng.randint(1, 100, (2, mh, mw))
        tex = ((d[0] ** 2 + d[1] ** 2) // 2).astype(np.float64)
        a = tex / tex.mean()
        dqp = gain * (a - 1) / (a + alpha) - gain / alpha
        dist = np.abs(dqp - np.round(dqp)).min()
        if dist < best_d:
            best, best_d = d, dist
    amp = np.where(yy[None, :, None, :] < 8, best[0][:, None, :, None],
                   best[1][:, None, :, None])
    cur = (128 + sign[None, :, None, :] * amp).reshape(H, W).astype(np.uint8)
    return cur, cur.copy(), best_d


def test_vaa_and_scene_score():
    for H, W, seed in ((48, 64, 0), (48, 64, 1), (720, 1280, 2)):
        a, b = _pair(H, W, seed)
        want = jp.vaa_calc(a, b)
        got = tp.vaa_calc(T(a), T(b))
        for g, w, name in zip(got, want, want._fields):
            eq(g, w, name)
        assert np.float32(jp.scene_change_score(a, b)) == \
            tp.scene_change_score(T(a), T(b)).numpy()


@pytest.mark.parametrize("ratio", [None, jp.SCENE_CHANGE_RATIO_MEDIUM,
                                   "score", 0.0, 1.0])
def test_is_scene_change(ratio):
    """is_scene_change equals the JAX helper on the four kinds of content
    and on frames whose share of moving 8x8 blocks is k/48 for every k,
    at the default and the medium ratio, at a ratio equal to the float32
    score itself (strictly greater is required) and at 0 and 1."""
    rng = np.random.default_rng(5)
    pairs = [_pair(48, 64, seed) for seed in range(4)]
    for k in range(49):
        moving = np.zeros(48, bool)
        moving[rng.permutation(48)[:k]] = True
        cur = np.kron(moving.reshape(6, 8), np.full((8, 8), 255))
        pairs.append((cur.astype(np.uint8), np.zeros((48, 64), np.uint8)))
    for a, b in pairs:
        if ratio is None:
            args = ()
        elif ratio == "score":
            args = (float(jp.scene_change_score(a, b)),)
        else:
            args = (ratio,)
        want = jp.is_scene_change(a, b, *args)
        got = tp.is_scene_change(T(a), T(b), *args)
        assert type(got) is bool and got == want


@pytest.mark.parametrize("H,W,seeds", [(48, 64, range(40)),
                                       (720, 1280, range(12)),
                                       (1088, 1920, range(4))])
def test_aq_map(H, W, seeds):
    for seed in seeds:
        a, b = _pair(H, W, seed)
        for mode in (jp.AQ_QUALITY_MODE, jp.AQ_BITRATE_MODE):
            wd, wm = jp.adaptive_quant_map(a, b, mode=mode)
            gd, gm = tp.adaptive_quant_map(T(a), T(b), mode=mode)
            eq(gd, wd, f"seed {seed} mode {mode} dqp")
            assert gd.dtype == np.int8
            assert gm == np.float32(wm), (seed, mode, gm, wm)


@pytest.mark.parametrize("H,W,seeds", [(48, 64, range(30)),
                                       (720, 1280, range(3))])
def test_aq_map_near_integer_dqp(H, W, seeds):
    for seed in seeds:
        a, b, dist = _boundary_pair(H, W, seed, trials=300 if H < 100 else 20)
        assert dist < (2e-3 if H < 100 else 1e-4)
        wd, wm = jp.adaptive_quant_map(a, b)
        gd, gm = tp.adaptive_quant_map(T(a), T(b))
        eq(gd, wd, f"seed {seed} dqp")
        assert gm == np.float32(wm)


def test_xla_sums():
    """The emulated orders against XLA's own float32 mean and row sums."""
    rng = np.random.RandomState(3)
    mean = jax.jit(lambda x: x.mean())
    rows = jax.jit(lambda x: x.sum(1))
    for shape in ((3, 4), (45, 80), (30, 40), (45, 33)):
        for _ in range(5):
            x = (rng.standard_normal(shape) * 1e4).astype(np.float32)
            got = tp._xla_sum_all(x) * (np.float32(1) / np.float32(x.size))
            assert np.float32(got) == np.float32(mean(x)), shape
    for shape in ((65, 656), (65, 32), (7, 1000)):
        x = (rng.standard_normal(shape) * 37).astype(np.float32)
        eq(tp._xla_sum_rows(x), rows(x), f"rows {shape}")


def test_pixel_functions():
    rng = np.random.RandomState(5)
    for H, W in ((48, 64), (37, 51), (720, 1280)):
        a = rng.randint(0, 256, (H, W)).astype(np.uint8)
        b = rng.randint(0, 256, (H, W)).astype(np.uint8)
        eq(tp.downsample2x(T(a)), jp.downsample2x(a), "downsample2x")
        eq(tp.upsample2x(T(a)), jp.upsample2x(a), "upsample2x")
        for g, w in zip(tp.downsample_pyramid(T(a), 3),
                        jp.downsample_pyramid(a, 3)):
            eq(g, w, "pyramid")
        flat = np.clip(np.full((H, W), 100) + rng.randint(-9, 10, (H, W)),
                       0, 255).astype(np.uint8)
        flat[: H // 3] = a[: H // 3]          # an edge region stays
        eq(tp.denoise(T(flat)), jp.denoise(flat), "denoise")
        for deg in (0, 90, 180, 270, -90, 450):
            eq(tp.image_rotate(T(a), deg), jp.image_rotate(a, deg), "rotate")
        if H % 16 == 0:
            assert int(tp.frame_complexity(T(a), T(b))) == \
                int(jp.frame_complexity(a, b))
            c = a.copy()
            c[16:32] = np.clip(c[16:32].astype(int) + rng.randint(
                -2, 3, (16, W)), 0, 255)
            c[: 16] = b[: 16]
            eq(tp.background_mask(T(c), T(a)), jp.background_mask(c, a),
               "background_mask")
            assert tp.background_mask(T(c), T(a)).any()


@pytest.mark.parametrize("H,W", [(720, 1280), (96, 64), (130, 40)])
def test_scroll_detect(H, W):
    rng = np.random.RandomState(H)
    tall = rng.randint(0, 256, (H + 80, W)).astype(np.uint8)
    hits = 0
    for dy in list(range(-33, 34, 3)) + [0, 1, -1]:
        cur = tall[40:40 + H]
        ref = tall[40 - dy:40 - dy + H] if abs(dy) <= 40 else cur
        want = jp.scroll_detect(cur, ref)
        got = tp.scroll_detect(T(cur), T(ref))
        assert got == (bool(want[0]), int(want[1])), dy
        hits += got[0]
    assert hits > 5
    with pytest.raises(ValueError):
        tp.scroll_detect(T(tall[:64]), T(tall[:64]))


# ---------------------------------------------------------------------------
# the pinned rate controllers
# ---------------------------------------------------------------------------
def _state(rc):
    return {k: v for k, v in vars(rc).items()}


def _drive(make, seed, n=80):
    """The same random call sequence on the JAX controller and its copy:
    every output and the whole state after every call must agree."""
    rng = np.random.RandomState(seed)
    a, b = make(jrc), make(trc)
    ts = 0.0
    for i in range(n):
        ts += float(rng.choice([0, 20, 40, 400]))
        stamp = None if i % 7 == 3 else ts
        is_idr = i == 0 or rng.rand() < 0.1
        if is_idr:
            a.tick(stamp)
            b.tick(stamp)
        else:
            sa, sb = a.should_skip(stamp), b.should_skip(stamp)
            assert sa == sb
            if sa:
                continue
        if hasattr(a, "report_delivery"):
            on_time = bool(rng.rand() < 0.6)
            a.report_delivery(on_time)
            b.report_delivery(on_time)
        cx = float(rng.choice([0.0, rng.uniform(1e3, 5e7)]))
        idc = int(rng.randint(0, 3))
        assert a.frame_qp(cx, is_idr, timestamp_ms=stamp, scene_idc=idc) == \
            b.frame_qp(cx, is_idr, timestamp_ms=stamp, scene_idc=idc)
        if hasattr(a, "gom_dqp"):
            rows = rng.randint(0, 10 ** rng.randint(1, 7), rng.randint(0, 9))
            eq(b.gom_dqp(rows), a.gom_dqp(rows), "gom_dqp")
        bits = float(rng.uniform(100, 4e5) * (3 if is_idr else 1))
        a.update(bits)
        b.update(bits)
        assert _state(a) == _state(b), i


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["bitrate", "bitrate_skip", "timestamp",
                                  "buffer", "screen"])
def test_ratectl_copy_matches(kind, seed):
    make = {
        "bitrate": lambda m: m.RateControl(300_000, 25.0, qp_init=30),
        "bitrate_skip": lambda m: m.RateControl(
            80_000, 30.0, frame_skip=True, skip_buffer_ratio=0.3,
            max_bitrate_bps=120_000),
        "timestamp": lambda m: m.TimestampRC(100_000, 25.0, qp_init=34),
        "buffer": lambda m: m.BufferBasedRC(qp_init=30),
        "screen": lambda m: m.ScreenContentRC(200_000, 10.0, qp_init=28),
    }[kind]
    _drive(make, seed)


def test_ratectl_functions_and_constants():
    for qp in range(52):
        assert trc.qstep(qp) == jrc.qstep(qp)
    for step in (0.0, 1e-9, 0.4, 0.85, 3.3, 77.0, 900.0):
        assert trc.qstep_to_qp(step) == jrc.qstep_to_qp(step)
    assert (trc.SCENE_IDC_NONE, trc.SCENE_IDC_MEDIUM, trc.SCENE_IDC_LARGE) \
        == (jrc.SCENE_IDC_NONE, jrc.SCENE_IDC_MEDIUM, jrc.SCENE_IDC_LARGE)
    for cls in ("RateControl", "TimestampRC", "BufferBasedRC",
                "ScreenContentRC"):
        for name in ("MAX_DELTA_QP", "BUFFER_DRAIN"):
            assert getattr(getattr(trc, cls), name, None) == \
                getattr(getattr(jrc, cls), name, None)
