"""GOP-parallel pixel decode (port of losslessh264_tpu/parallel/decode.py).

Each GOP segment of the native shard plan is decoded as a self-contained
stream (its SPS/PPS context + its bytes) by its own TorchDecoder on a
host thread; the segments' frames join in stream order. On CUDA every
worker launches on its own torch.cuda.Stream, so the segments' K1 and K2
launches can overlap on the one card; the kernel library is built before
the threads start.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import _build, native


def decode_yuv_gop_parallel(data: bytes, max_workers: int = 8,
                            device="cuda"):
    """Decode an Annex-B .264 to a list of (Y, U, V) numpy frames,
    GOP-parallel. Frames and crop equal the sequential TorchDecoder's.
    `device` takes the place of the JAX function's use_jax flag.
    Returns (frames, crop_px)."""
    from ..decoder_torch import TorchDecoder

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("decode_yuv_gop_parallel: device 'cuda' "
                               "requested but torch.cuda.is_available() "
                               "is False")
        _build.lib()
    plan = native.shard_plan(data, max_workers)

    def one(seg):
        start, end, ctx = seg
        ctx_mgr = (torch.cuda.stream(torch.cuda.Stream(dev))
                   if dev.type == "cuda" else contextlib.nullcontext())
        with ctx_mgr:
            dec = TorchDecoder(ctx + data[start:end], device=dev)
            frames = [tuple(p.cpu().numpy() for p in f)
                      for f in dec.frames()]
        return frames, dec.crop_px

    if len(plan) == 1:
        return one(plan[0])
    with ThreadPoolExecutor(max_workers=min(max_workers, len(plan))) as ex:
        results = list(ex.map(one, plan))
    frames = [f for fr, _ in results for f in fr]
    return frames, results[0][1]
