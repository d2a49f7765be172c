"""Command line of the torch port.

    python -m losslessh264_tpu_torch decode in.264 out.yuv
        [--device cuda|cpu] [--stats]

Decodes an H.264 stream with TorchDecoder and writes the frames as raw
I420 (cropped per the SPS, as the reference decoder writes them). The
default device is cuda, which raises when no GPU is present. Compress,
decompress and roundtrip stay with `python -m losslessh264_tpu`.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m losslessh264_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dp = sub.add_parser("decode", help="decode in.264 to raw I420 out.yuv")
    dp.add_argument("input")
    dp.add_argument("output")
    dp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dp.add_argument("--stats", action="store_true",
                    help="print frame count and rate to stderr")
    args = ap.parse_args(argv)

    from losslessh264_tpu import decoder_np as dnp

    from .decoder_torch import TorchDecoder

    with open(args.input, "rb") as fh:
        data = fh.read()
    dec = TorchDecoder(data, device=args.device)
    t0 = time.perf_counter()
    n_frames = 0
    with open(args.output, "wb") as fh:
        for yuv in dec.frames():
            yuv = tuple(p.cpu().numpy() for p in yuv)
            for plane in dnp.crop_yuv(yuv, dec.crop_px):
                fh.write(plane.tobytes())
            n_frames += 1
    if args.stats:
        dt = time.perf_counter() - t0
        print(f"decoded {n_frames} frames on {args.device} "
              f"({n_frames / dt:.2f} fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
