"""Video pre-processing for the encoder (torch).

Port of the part of losslessh264_tpu/processing.py that the encoder's
fused path uses: the scene-change score that `TorchEncoder(scene_cut=True)`
turns into an IDR (reference SceneChangeDetection.h:52-56,111: an 8x8
block whose zero-MV SAD exceeds HIGH_MOTION_BLOCK_THRESHOLD is a motion
block; ratios above 0.85 / 0.50 mark a large / medium scene change).
The rest of that module (AQ, background and scroll detection, denoise,
complexity) is still to be ported (ROADMAP M9).
"""
from __future__ import annotations

import torch

HIGH_MOTION_BLOCK_THRESHOLD = 320
SCENE_CHANGE_RATIO_LARGE = 0.85
SCENE_CHANGE_RATIO_MEDIUM = 0.50


def scene_change_score(cur, ref):
    """Fraction of 8x8 blocks of luma [H, W] (8 | H, W) whose zero-MV SAD
    exceeds the high-motion threshold, as a float32 0-d tensor. The
    blocks are counted as an integer (JAX's float32 sum of the 0/1 flags
    is exact below 2^24 blocks); JAX's mean then divides by the constant
    block count, which XLA compiles into a product with its float32
    reciprocal, and so does this (9/20 is one ulp above 9.0f / 20.0f)."""
    d = torch.abs(cur.to(torch.int32) - ref.to(torch.int32))
    H, W = d.shape
    sad8 = d.reshape(H // 8, 8, W // 8, 8).sum((1, 3), dtype=torch.int32)
    count = (sad8 > HIGH_MOTION_BLOCK_THRESHOLD).sum()
    inv = torch.ones((), dtype=torch.float32,
                     device=d.device) / sad8.numel()
    return count.to(torch.float32) * inv
