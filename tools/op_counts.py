#!/usr/bin/env python3
"""Count the torch ops the host issues in the residual and deblock
stages, per frame, on the device given (run from the repo root):

    python3 tools/op_counts.py [cpu|cuda]

- decode residual: decoder_torch._residual_recon on synth720p frames 0-3
  (the residual stage of _residual_and_inter, its inter prediction not
  counted), each frame on the rings its decode gives it
  (cases.residual_frames);
- decode deblock: ops/deblock.deblock_frame (K9 and K2) on frames 0-3 of
  a TorchDecoder decode of synth720p;
- encode residual: encoder_torch.inter_residual on the P frames 1-3 of
  encode configuration A (tests/data/synth720p_enc_golden.json) of
  synth720p's first decoded frames;
- encode deblock: encoder_torch._deblock_recon (the working planes, K9,
  K2 in place, the crop) on every frame of that encode.

A torch.utils._python_dispatch.TorchDispatchMode counts every aten op
dispatched inside the call, apart as views (OpOverload.is_view) and the
rest. On the CPU the wrappers take their plain versions, so the counts
are those of the plain code (the port's code on the card before K7, K8
and K9): there K2's half, ops/deblock.deblock_planes, is counted as its
wrapper ran before K9 (OLD_K2_WRAPPER: the dict packed by _pack_params,
int32 copies of the planes, the scratch; no launch), not as the plain
wavefront, and the deblock then runs again uncounted. On the card the
counts are the kernels' wrappers'. Prints one line per frame and a JSON
summary line."""
import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from losslessh264_tpu_torch import decoder_torch as dt  # noqa: E402
from losslessh264_tpu_torch import encoder_torch as et  # noqa: E402
from losslessh264_tpu_torch.cases import (golden_encoder,  # noqa: E402
                                          residual_frames)
from losslessh264_tpu_torch.ops import deblock as tdb  # noqa: E402


class Count(TorchDispatchMode):
    """The aten ops dispatched while the mode is on: views and the rest."""

    def __init__(self):
        super().__init__()
        self.ops = self.views = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.is_view:
            self.views += 1
        else:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def OLD_K2_WRAPPER(mb_w, mb_h, Yw, Uw, Vw, params, inplace=False):
    """The host ops of K2's wrapper as the card ran it before K9, with no
    launch: the _edge_params dict packed, int32 copies of the planes, the
    sync scratch. Returns the planes unfiltered."""
    tdb._pack_params(params).contiguous()
    planes = tuple(a.to(torch.int32).contiguous().clone()
                   for a in (Yw, Uw, Vw))
    torch.empty(1 + 2 * mb_h, dtype=torch.int32, device=Yw.device)
    return planes


def counted(module, name, device, out, what):
    """module.<name> replaced by a version that counts each call's ops
    into out[what] and prints them; on the CPU the call is counted with
    OLD_K2_WRAPPER in place of deblock_planes, then run again uncounted
    (its result is the real one)."""
    real = getattr(module, name)

    def call(*args, **kw):
        swap = device == "cpu" and what.endswith("deblock")
        if swap:
            tdb.deblock_planes = OLD_K2_WRAPPER
        try:
            with Count() as c:
                res = real(*args, **kw)
        finally:
            tdb.deblock_planes = deblock_planes
        if swap:
            res = real(*args, **kw)
        out[what].append((c.ops, c.views))
        print(f"{what} call {len(out[what])}: {c.ops} ops, {c.views} views "
              f"on {device}", flush=True)
        return res

    call.launches = 0
    return real, call


deblock_planes = tdb.deblock_planes


def main():
    device = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("op_counts.py cuda needs a CUDA device")
    torch.set_num_threads(min(8, os.cpu_count()))
    data = open(os.path.join(ROOT, "tests", "data", "synth720p.264"),
                "rb").read()
    out = {"device": device, "decode": [], "encode": [],
           "decode deblock": [], "encode deblock": []}
    for i, mb_w, mb_h, p, *pred in residual_frames(data, device):
        with Count() as c:
            dt._residual_recon(mb_w, mb_h, p, *pred)
        out["decode"].append((c.ops, c.views))
        print(f"decode frame {i} residual stage: {c.ops} ops, {c.views} "
              f"views on {device}", flush=True)
        if i == 3:
            break

    real, call = counted(tdb, "deblock_frame", device, out, "decode deblock")
    tdb.deblock_frame = call
    try:
        frames = [tuple(np.ascontiguousarray(a.cpu().numpy()) for a in yuv)
                  for _, yuv in zip(range(4), dt.TorchDecoder(
                      data, device=device).frames())]
    finally:
        tdb.deblock_frame = real
    gold = json.load(open(os.path.join(ROOT, "tests", "data",
                                       "synth720p_enc_golden.json")))
    enc = golden_encoder(gold["A"], gold["source"]["width"],
                         gold["source"]["height"], device)
    patched = [counted(et, "inter_residual", device, out, "encode"),
               counted(et, "_deblock_recon", device, out, "encode deblock")]
    for (real, call), name in zip(patched, ("inter_residual",
                                            "_deblock_recon")):
        setattr(et, name, call)
    try:
        for f in frames:
            enc.encode_frame(*f)
    finally:
        for (real, call), name in zip(patched, ("inter_residual",
                                                "_deblock_recon")):
            setattr(et, name, real)
            if hasattr(real, "launches"):
                real.launches += call.launches
    print(json.dumps(out))


if __name__ == "__main__":
    main()
