"""Video pre-processing for the encoder (torch, device-agnostic).

Port of losslessh264_tpu/processing.py, the reference's `codec/processing`
plugin library as whole-frame reductions: VAA (vaacalcfuncs.cpp), scene
change (SceneChangeDetection.h:52-56,111: an 8x8 block whose zero-MV SAD
exceeds HIGH_MOTION_BLOCK_THRESHOLD is a motion block; ratios above 0.85 /
0.50 mark a large / medium change), adaptive quantization
(AdaptiveQuantization.cpp:93-176), the dyadic down/upsampler, frame
complexity, background and scroll detection, denoise and image rotation.

Integer work runs on the tensors' device. Two functions end in float32
arithmetic whose result depends on the order of the additions:
`adaptive_quant_map` (the mean of a per-MB index plane) and
`scroll_detect` (its row-profile costs). The JAX reference compiles them
with XLA on the CPU, which splits a long reduction into windows of 32
(padded on both sides, each window summed in order) and sums the window
partials with LLVM's vectorized loop. Those float32 tails run here on the
host in numpy in exactly that order (`_xla_sum_rows`, `_xla_sum_all`), so
the CPU and the card give the same bits; the device hands over small
exact integer planes, and the encoder needs the result on the host anyway
(the per-MB QP plane goes to the writer).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

HIGH_MOTION_BLOCK_THRESHOLD = 320
SCENE_CHANGE_RATIO_LARGE = 0.85
SCENE_CHANGE_RATIO_MEDIUM = 0.50

# AQ integer-model constants (AdaptiveQuantization.cpp:38-42, util.h:62-65)
AQ_TIME_INT_MULTIPLY = 10_000
AVERAGE_TIME_MOTION = 3000
AVERAGE_TIME_TEXTURE_QUALITYMODE = 10_000
AVERAGE_TIME_TEXTURE_BITRATEMODE = 8750
MODEL_ALPHA = 9910
MODEL_TIME = 58185

AQ_QUALITY_MODE = 0
AQ_BITRATE_MODE = 1

_F32 = np.float32
_WIN = 32   # XLA CPU's tree-reduction window


class VaaResult(NamedTuple):
    sad8x8: torch.Tensor      # [mb_h, mb_w, 4] zero-MV SAD per 8x8 quadrant
    ssd16x16: torch.Tensor    # [mb_h, mb_w] sum of squared diffs per MB
    sum16x16: torch.Tensor    # [mb_h, mb_w] sum of cur samples per MB
    sqsum16x16: torch.Tensor  # [mb_h, mb_w] sum of squared cur samples


def _block_reduce(x, by, bx):
    """int32 sum over non-overlapping (by, bx) blocks of [H, W]."""
    H, W = x.shape
    return x.reshape(H // by, by, W // bx, bx).sum((1, 3), dtype=torch.int32)


# ---------------------------------------------------------------------------
# float32 sums in XLA CPU's order
# ---------------------------------------------------------------------------
def _windows(n):
    """(window, left pad, right pad) of XLA's tree-reduction rewrite of a
    reduced dimension of size n (split only when n exceeds the window)."""
    if n <= _WIN:
        return n, 0, 0
    p = -(-n // _WIN) * _WIN - n
    return _WIN, p // 2, p - p // 2


def _seq(x, axis=-1):
    """float32 sums along `axis`, each strictly left to right from 0."""
    return np.cumsum(np.asarray(x, _F32), axis=axis, dtype=_F32).take(
        -1, axis=axis)


def _xla_sum_rows(x):
    """float32 [R, n] -> [R]: the sum of each row as XLA CPU computes a
    reduce over the minor dimension (windows of 32 in order, then the
    window partials in order)."""
    x = np.asarray(x, _F32)
    R, n = x.shape
    w, lo, hi = _windows(n)
    if w == n:
        return _seq(x)
    xp = np.zeros((R, n + lo + hi), _F32)
    xp[:, lo:lo + n] = x
    return _xla_sum_rows(_seq(xp.reshape(R, -1, w)))


def _xla_sum_all(x):
    """float32 [H, W] -> scalar: the sum of all elements as XLA CPU computes
    a full reduce of a 2-D plane: windows of 32x32 (row-major, each from
    0), then the window partials: two rows of them as two vector lanes
    (each row in order, then lane 0 + lane 1), any other count in
    row-major order. tests/test_torch_processing.py pins it against XLA
    at 64x48, 720p and 1080p."""
    x = np.asarray(x, _F32)
    H, W = x.shape
    wy, ty, by = _windows(H)
    wx, tx, bx = _windows(W)
    if wy == H and wx == W:
        return _seq(x.reshape(-1))
    xp = np.zeros((H + ty + by, W + tx + bx), _F32)
    xp[ty:ty + H, tx:tx + W] = x
    nh, nw = xp.shape[0] // wy, xp.shape[1] // wx
    part = _seq(xp.reshape(nh, wy, nw, wx).transpose(0, 2, 1, 3)
                .reshape(nh, nw, wy * wx))
    if nh == 2:     # LLVM vectorizes the two rows of partials as lanes
        return _seq(_seq(part))
    return _seq(part.reshape(-1))


# ---------------------------------------------------------------------------
# analyses
# ---------------------------------------------------------------------------
def vaa_calc(cur, ref):
    """Variance/SAD analysis of a luma frame [H, W] (16 | H, W) against the
    previous one; int32 planes on the input's device."""
    c = cur.to(torch.int32)
    r = ref.to(torch.int32)
    d = c - r
    sad8 = _block_reduce(torch.abs(d), 8, 8)
    mh, mw = sad8.shape[0] // 2, sad8.shape[1] // 2
    sad8x8 = sad8.reshape(mh, 2, mw, 2).permute(0, 2, 1, 3).reshape(mh, mw, 4)
    return VaaResult(sad8x8, _block_reduce(d * d, 16, 16),
                     _block_reduce(c, 16, 16), _block_reduce(c * c, 16, 16))


def scene_change_score(cur, ref):
    """Fraction of 8x8 blocks of luma [H, W] (8 | H, W) whose zero-MV SAD
    exceeds the high-motion threshold, as a float32 0-d tensor. The
    blocks are counted as an integer (JAX's float32 sum of the 0/1 flags
    is exact below 2^24 blocks); JAX's mean then divides by the constant
    block count, which XLA compiles into a product with its float32
    reciprocal, and so does this (9/20 is one ulp above 9.0f / 20.0f)."""
    d = torch.abs(cur.to(torch.int32) - ref.to(torch.int32))
    sad8 = _block_reduce(d, 8, 8)
    count = (sad8 > HIGH_MOTION_BLOCK_THRESHOLD).sum()
    inv = torch.ones((), dtype=torch.float32,
                     device=d.device) / sad8.numel()
    return count.to(torch.float32) * inv


def is_scene_change(cur, ref, ratio: float = SCENE_CHANGE_RATIO_LARGE):
    """Whether scene_change_score exceeds `ratio` (a host bool), as the
    JAX helper compares its float32 score with the Python float."""
    return bool(scene_change_score(cur, ref) > ratio)


def adaptive_quant_map(cur, ref, mode: int = AQ_QUALITY_MODE):
    """Per-MB delta-QP map and its mean, as host numpy (int8 [mb_h, mb_w],
    float32 scalar): the model of AdaptiveQuantization.cpp Process in the
    normalized float32 of the JAX reference (each MB's motion and texture
    index against a weighted frame average, dqp = MODEL_TIME * (a - 1) /
    (a + MODEL_ALPHA); the texture term always, the motion term when
    negative in quality mode; truncated toward zero).

    The index planes are exact integers (|value| <= 65025), computed on
    the device in int32 and fetched once; the float32 tail runs on the
    host in XLA CPU's order of additions (module docstring)."""
    vaa = vaa_calc(cur, ref)
    sum_diff = vaa.sad8x8.sum(2, dtype=torch.int32) >> 8
    usum = vaa.sum16x16 >> 8
    idx = torch.stack([(vaa.sqsum16x16 >> 8) - usum * usum,
                       (vaa.ssd16x16 >> 8) - sum_diff * sum_diff])
    texture, motion = idx.cpu().numpy().astype(_F32)

    alpha = _F32(MODEL_ALPHA / AQ_TIME_INT_MULTIPLY)
    gain = _F32(MODEL_TIME / AQ_TIME_INT_MULTIPLY)
    w_motion = AVERAGE_TIME_MOTION / AQ_TIME_INT_MULTIPLY
    w_texture = ((AVERAGE_TIME_TEXTURE_QUALITYMODE
                  if mode == AQ_QUALITY_MODE else
                  AVERAGE_TIME_TEXTURE_BITRATEMODE) / AQ_TIME_INT_MULTIPLY)
    inv_n = _F32(1) / _F32(texture.size)   # XLA's mean: sum * (1/n)

    def component(ix, weight):
        avg = _F32(_xla_sum_all(ix) * inv_n)
        avg = _F32(1) if abs(avg) <= _F32(1e-6) else avg
        if weight != 1.0:                  # XLA folds the product by 1
            avg = _F32(avg * _F32(weight))
        a = ix / avg
        return (a + _F32(-1)) * gain / (a + alpha)

    dqp = component(texture, w_texture)
    dqp_m = component(motion, w_motion)
    if mode == AQ_QUALITY_MODE:
        dqp = dqp + np.where(dqp_m < 0, dqp_m, _F32(0))
    else:
        dqp = dqp + dqp_m
    return (np.trunc(dqp).astype(np.int8),
            _F32(_xla_sum_all(dqp) * inv_n))


def downsample2x(plane):
    """Dyadic halve with rounding ((a+b+c+d+2)>>2, the reference's
    DyadicBilinearDownsampler); odd trailing rows/columns are dropped."""
    p = plane.to(torch.int32)
    H, W = p.shape
    q = p[:H & ~1, :W & ~1].reshape(H // 2, 2, W // 2, 2).sum(
        (1, 3), dtype=torch.int32)
    return ((q + 2) >> 2).to(torch.uint8)


def upsample2x(plane):
    """Dyadic 2x integer bilinear upsample, co-sited with downsample2x:
    even samples copy, odd samples round-average their neighbours (edge
    clamp). The inter-layer contract of simulcast.py depends on encoder
    and decoder computing the identical plane."""
    p = plane.to(torch.int32)
    H, W = p.shape
    right = torch.cat([p[:, 1:], p[:, -1:]], 1)
    rows = torch.stack([p, (p + right + 1) >> 1], 2).reshape(H, 2 * W)
    below = torch.cat([rows[1:], rows[-1:]], 0)
    out = torch.stack([rows, (rows + below + 1) >> 1], 1)
    return out.reshape(2 * H, 2 * W).to(torch.uint8)


def downsample_pyramid(plane, levels: int):
    """[full, 1/2, 1/4, ...] dyadic pyramid."""
    out = [plane]
    for _ in range(levels - 1):
        out.append(downsample2x(out[-1]))
    return out


def frame_complexity(cur, ref):
    """Frame SAD complexity (ComplexityAnalysis FRAME_SAD), an int32 0-d
    tensor (a 720p frame's SAD is below 2^31)."""
    return torch.abs(cur.to(torch.int32) - ref.to(torch.int32)).sum(
        dtype=torch.int32)


def background_mask(cur, ref):
    """Per-MB background flag [mb_h, mb_w]: all four 8x8 quadrants below a
    quarter of the motion threshold and a low SSD (BackgroundDetection's
    static-block criterion, simplified to its SAD test)."""
    vaa = vaa_calc(cur, ref)
    quiet = (vaa.sad8x8 < HIGH_MOTION_BLOCK_THRESHOLD // 4).all(2)
    return quiet & (vaa.ssd16x16 < HIGH_MOTION_BLOCK_THRESHOLD * 4)


def scroll_detect(cur, ref, max_shift: int = 32):
    """Dominant vertical scroll: (detected, dy) as host (bool, int), the dy
    in [-max_shift, max_shift] whose row profiles match best (the first
    minimum of the cost), with cur[y] ~= ref[y + dy]; detected when that
    cost is under half the zero shift's and dy != 0.

    The row sums are exact integers (<= 255 * W) from the device; JAX's
    row mean multiplies them by the float32 reciprocal of W (a division by
    a constant under XLA) and sums the |differences| over H - 2*max_shift
    rows in XLA CPU's order, as this does on the host."""
    rows = torch.stack([cur.to(torch.int32).sum(1, dtype=torch.int32),
                        ref.to(torch.int32).sum(1, dtype=torch.int32)])
    H, W = cur.shape
    span = H - 2 * max_shift
    if span <= 0:
        raise ValueError(f"scroll_detect needs more than {2 * max_shift} "
                         f"rows, got {H}")
    inv_w = _F32(1) / _F32(W)
    c, r = rows.cpu().numpy().astype(_F32) * inv_w
    shifts = np.arange(2 * max_shift + 1)
    cs = c[shifts[:, None] + np.arange(span)[None, :]]
    costs = _xla_sum_rows(np.abs(cs - r[max_shift:max_shift + span]))
    best = int(np.argmin(costs))
    dy = max_shift - best
    return bool(costs[best] * _F32(2) < costs[max_shift] and dy != 0), dy


def denoise(Y):
    """Edge-preserving smoothing: the rounded 3x3 mean (edge-replicated)
    where a sample is within 8 of it (denoise.cpp's flat-region filter)."""
    p = Y.to(torch.int32)
    H, W = p.shape
    pad = F.pad(p[None, None].to(torch.float32), (1, 1, 1, 1),
                mode="replicate")[0, 0].to(torch.int32)
    acc = torch.zeros_like(p)
    for dy in range(3):
        for dx in range(3):
            acc = acc + pad[dy:dy + H, dx:dx + W]
    mean = torch.div(acc + 4, 9, rounding_mode="floor")
    return torch.where(torch.abs(p - mean) < 8, mean, p).to(torch.uint8)


def image_rotate(plane, degrees: int):
    """Rotation by a multiple of 90 degrees, clockwise (imagerotate)."""
    k = (degrees // 90) % 4
    return torch.rot90(plane, -k) if k else plane
