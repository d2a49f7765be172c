"""Seeded 4:2:0 source frames: a textured pan with intra patches.

A frozen copy of losslessh264_tpu_torch/cases.patch_frames, computed
from one canvas: frame i of the pan is the canvas window that starts i
steps of (2, 3) pixels down and right, so a clip of n frames costs one
canvas of (H + 2n) x (W + 3n) and a copy per frame. For the same seed,
plan and noise the frames equal patch_frames' (a test holds the two
together); the random draws come in the same order.
"""
from __future__ import annotations

import numpy as np


def pan_frames(width, height, plan, noise=0, seed=0):
    """len(plan) I420 frames (uint8 numpy Y, U, V): a smooth luma pattern
    with a texture of amplitude 10, translating by (2, 3) px per frame,
    fresh noise of amplitude `noise` on every luma sample, and on frame i
    one MB per diagonal of plan[i] (d = 2 * mby + mbx, in the first MB row
    that holds it) filled with noise of amplitude 5 around 250 on odd
    frames and around 5 on even ones, which neither the pattern nor the
    frame before predicts, so a P frame codes it intra. Chroma is flat."""
    rng = np.random.RandomState(seed)
    mb_w, mb_h = width // 16, height // 16
    n = len(plan)
    tex = rng.randint(-10, 11, (height + 2 * n, width + 3 * n))
    rr, cc = np.mgrid[0:height + 2 * n, 0:width + 3 * n].astype(np.float64)
    canvas = (125 + 35 * np.sin(cc / 23.0) + 30 * np.cos(rr / 17.0)).round()
    canvas += tex
    del rr, cc, tex
    if not noise:
        # clipping commutes with the window copies and the patches, whose
        # values lie in 0..255: clip once and copy bytes
        canvas = np.clip(canvas, 0, 255).astype(np.uint8)
    U = np.full((height // 2, width // 2), 110, np.uint8)
    V = np.full((height // 2, width // 2), 150, np.uint8)
    frames = []
    for i, diags in enumerate(plan):
        Y = canvas[2 * i:2 * i + height, 3 * i:3 * i + width].copy()
        if noise:
            Y += rng.randint(-noise, noise + 1, Y.shape)
        for d in diags:
            y = max(0, -(-(d - mb_w + 1) // 2))
            x = d - 2 * y
            if not (0 <= x < mb_w and y < mb_h):
                raise ValueError(f"no MB on diagonal {d}")
            Y[y * 16:y * 16 + 16, x * 16:x * 16 + 16] = \
                (250 if i % 2 else 5) + rng.randint(-5, 6, (16, 16))
        if noise:
            Y = np.clip(Y, 0, 255).astype(np.uint8)
        frames.append((Y, U, V))
    return frames


def patch_plan(rng, width, height, n_frames, per_frame):
    """[n_frames] lists of `per_frame` distinct MB diagonals drawn by
    `rng` (a numpy Generator): every seed gets the same number of patches
    in each frame, at other places."""
    mb_w, mb_h = width // 16, height // 16
    n_diags = 2 * (mb_h - 1) + mb_w
    return [sorted(int(d) for d in rng.choice(n_diags, per_frame,
                                              replace=False))
            for _ in range(n_frames)]
