#!/usr/bin/env python3
"""Count the torch ops the host issues in the two residual stages, per
frame, on the device given (run from the repo root):

    python3 tools/op_counts.py [cpu|cuda]

- decode: decoder_torch._residual_recon on synth720p frames 0-3 (the
  residual stage of _residual_and_inter, its inter prediction not
  counted), each frame on the rings its decode gives it
  (cases.residual_frames);
- encode: encoder_torch.inter_residual on the P frames 1-3 of encode
  configuration A (tests/data/synth720p_enc_golden.json) of synth720p's
  first decoded frames.

A torch.utils._python_dispatch.TorchDispatchMode counts every aten op
dispatched inside the call, apart as views (OpOverload.is_view) and the
rest. On the CPU the wrappers take their plain versions, so the counts
are those of the plain code (the port's code on the card before K7 and
K8); on the card they are the kernels' wrappers'. Prints one line per
frame and a JSON summary line."""
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


def main():
    device = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("op_counts.py cuda needs a CUDA device")
    torch.set_num_threads(min(8, os.cpu_count()))
    data = open(os.path.join(ROOT, "tests", "data", "synth720p.264"),
                "rb").read()
    out = {"device": device, "decode": [], "encode": []}
    for i, mb_w, mb_h, p, *pred in residual_frames(data, device):
        with Count() as c:
            dt._residual_recon(mb_w, mb_h, p, *pred)
        out["decode"].append((c.ops, c.views))
        print(f"decode frame {i} residual stage: {c.ops} ops, {c.views} "
              f"views on {device}", flush=True)
        if i == 3:
            break

    frames = [tuple(np.ascontiguousarray(a.cpu().numpy()) for a in yuv)
              for _, yuv in zip(range(4), dt.TorchDecoder(
                  data, device=device).frames())]
    gold = json.load(open(os.path.join(ROOT, "tests", "data",
                                       "synth720p_enc_golden.json")))
    enc = golden_encoder(gold["A"], gold["source"]["width"],
                         gold["source"]["height"], device)
    real = et.inter_residual

    def counted(*args):
        with Count() as c:
            res = real(*args)
        out["encode"].append((c.ops, c.views))
        print(f"encode A P frame {len(out['encode'])} residual stage: "
              f"{c.ops} ops, {c.views} views on {device}", flush=True)
        return res

    counted.launches = 0
    et.inter_residual = counted
    try:
        for f in frames:
            enc.encode_frame(*f)
    finally:
        et.inter_residual = real
        real.launches += counted.launches
    print(json.dumps(out))


if __name__ == "__main__":
    main()
