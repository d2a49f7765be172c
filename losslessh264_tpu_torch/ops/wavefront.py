"""Wavefront helpers shared by the intra/deblock pipelines (torch).

The slope-2 MB wavefront (2*row + col = const) guarantees that the local
windows of the MBs on one diagonal never overlap: MB strides are 16 px
and consecutive diagonal members are 2 MBs apart horizontally, so even
the deblock 24x24 windows (8 px left/top margin) stay disjoint. The
per-diagonal writeback is therefore one indexed write per plane.
Port of losslessh264_tpu/ops/wavefront.py.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def diagonals(mb_w, mb_h):
    """Slope-2 wavefront schedule: [nd, K] int32 MB indices per diagonal
    (2*row + col = d), each row's MBs first, -1 padding. Read-only.

    The deblocking filter needs slope 2, not 1: an MB's horizontal edge
    0 filters the bottom rows of the MB above at columns 13-15, which
    that MB's right neighbour's vertical edge 0 modified. Intra
    prediction reads the above-right MB, which slope 2 also orders."""
    diags = {}
    for i in range(mb_w * mb_h):
        y, x = divmod(i, mb_w)
        diags.setdefault(2 * y + x, []).append(i)
    nd = 2 * (mb_h - 1) + mb_w
    K = max(len(v) for v in diags.values())
    out = np.full((nd, K), -1, np.int32)
    for d, v in diags.items():
        out[d, :len(v)] = v
    out.setflags(write=False)
    return out


def scatter_tiles(plane, tiles, y0s, x0s, valid):
    """Write K non-overlapping [T,T] tiles into plane at (y0s[k], x0s[k]).

    Returns a new plane. Lanes with valid[k] False, and tile pixels that
    fall outside the plane, are dropped (JAX's scatter mode="drop"):
    they are routed to one scratch element past the end of a flat copy.
    Tiles must not overlap — guaranteed on a slope-2 diagonal.
    """
    H, W = plane.shape
    T = tiles.shape[1]
    r = torch.arange(T, device=plane.device)
    rows = y0s[:, None, None] + r[None, :, None]
    cols = x0s[:, None, None] + r[None, None, :]
    ok = (valid[:, None, None] & (rows >= 0) & (rows < H)
          & (cols >= 0) & (cols < W))
    idx = torch.where(ok, rows * W + cols, H * W).reshape(-1)
    flat = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
    flat[idx] = tiles.reshape(-1).to(plane.dtype)
    return flat[:H * W].reshape(H, W)
