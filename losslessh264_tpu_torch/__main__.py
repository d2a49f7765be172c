"""Command line of the torch port.

    python -m losslessh264_tpu_torch decode in.264 out.yuv
        [--device cuda|cpu] [--stats]
    python -m losslessh264_tpu_torch encode in.yuv WxH out.264
        [--qp 28] [--gop 0] [--bitrate BPS --fps 25] [--cabac] [--aq]
        [--denoise] [--refs 1|2] [--slices N] [--temporal-layers 1-4]
        [--spatial-layers 1-4] [--device cuda|cpu] [--stats]

`decode` turns an H.264 stream into raw I420 frames with TorchDecoder
(cropped per the SPS, as the reference decoder writes them). `encode`
reads raw I420 frames of size WxH and writes an H.264 stream with
TorchEncoder, with the flags of `python -m losslessh264_tpu encode`:
with --gop 0 (one IDR, then P frames) it cuts to an IDR at detected
scene changes; --bitrate turns on rate control (a RateControl at
--fps starting at --qp, with the per-row GOM plane); --spatial-layers N
writes N dyadic simulcast layers (SimulcastEncoder, without rate
control: one controller cannot serve several layers).
The default device is cuda, which raises when no GPU is present.
Compress, decompress and roundtrip stay with `python -m losslessh264_tpu`.
"""
from __future__ import annotations

import argparse
import sys
import time


def _decode(args):
    from .decoder_torch import TorchDecoder
    from .ref_np import crop_yuv

    with open(args.input, "rb") as fh:
        data = fh.read()
    dec = TorchDecoder(data, device=args.device)
    t0 = time.perf_counter()
    n_frames = 0
    with open(args.output, "wb") as fh:
        for yuv in dec.frames():
            yuv = tuple(p.cpu().numpy() for p in yuv)
            for plane in crop_yuv(yuv, dec.crop_px):
                fh.write(plane.tobytes())
            n_frames += 1
    if args.stats:
        dt = time.perf_counter() - t0
        print(f"decoded {n_frames} frames on {args.device} "
              f"({n_frames / dt:.2f} fps)", file=sys.stderr)


def _encode(args, ap):
    import numpy as np

    from . import ratectl
    from .encoder_torch import TorchEncoder
    from .simulcast import SimulcastEncoder

    W, H = (int(v) for v in args.dims.lower().split("x"))
    fsz = W * H * 3 // 2
    with open(args.input, "rb") as fh:
        raw = fh.read()
    n_frames = len(raw) // fsz
    if n_frames == 0:
        ap.error(f"input smaller than one {args.dims} I420 frame")
    rc = (ratectl.RateControl(args.bitrate, args.fps, qp_init=args.qp)
          if args.bitrate else None)
    kw = dict(qp=args.qp, gop=args.gop, rc=rc, scene_cut=args.gop == 0,
              cabac=args.cabac, aq=args.aq,
              temporal_layers=args.temporal_layers, gom_rc=rc is not None,
              refs=args.refs, slices=args.slices, denoise=args.denoise,
              device=args.device)
    if args.spatial_layers > 1:
        kw.update(rc=None, gom_rc=False)
        enc = SimulcastEncoder(W, H, spatial_layers=args.spatial_layers,
                               **kw)
    else:
        enc = TorchEncoder(W, H, **kw)
    t0 = time.perf_counter()
    with open(args.output, "wb") as fh:
        for i in range(n_frames):
            o = i * fsz
            Y = np.frombuffer(raw, np.uint8, W * H, o).reshape(H, W)
            U = np.frombuffer(raw, np.uint8, W * H // 4,
                              o + W * H).reshape(H // 2, W // 2)
            V = np.frombuffer(raw, np.uint8, W * H // 4,
                              o + W * H * 5 // 4).reshape(H // 2, W // 2)
            fh.write(enc.encode_frame(Y, U, V))
    if args.stats:
        dt = time.perf_counter() - t0
        print(f"encoded {n_frames} frames {args.dims} on {args.device} "
              f"({n_frames / dt:.2f} fps)", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m losslessh264_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dp = sub.add_parser("decode", help="decode in.264 to raw I420 out.yuv")
    dp.add_argument("input")
    dp.add_argument("output")
    ep = sub.add_parser("encode", help="encode raw I420 in.yuv to out.264")
    ep.add_argument("input")
    ep.add_argument("dims", help="frame size WxH")
    ep.add_argument("output")
    ep.add_argument("--qp", type=int, default=28)
    ep.add_argument("--gop", type=int, default=0,
                    help="IDR period (0: one IDR, then scene cuts)")
    ep.add_argument("--bitrate", type=float, default=0,
                    help="target bitrate in bit/s (turns on rate control)")
    ep.add_argument("--fps", type=float, default=25.0,
                    help="frame rate for rate control")
    ep.add_argument("--cabac", action="store_true")
    ep.add_argument("--aq", action="store_true",
                    help="per-MB adaptive quantization")
    ep.add_argument("--denoise", action="store_true",
                    help="luma denoise before the analysis")
    ep.add_argument("--refs", type=int, default=1, choices=(1, 2))
    ep.add_argument("--slices", type=int, default=1)
    ep.add_argument("--temporal-layers", type=int, default=1,
                    choices=(1, 2, 3, 4),
                    help="dyadic temporal layers (top-layer frames are "
                         "non-reference; 3-4 are hierarchical P)")
    ep.add_argument("--spatial-layers", type=int, default=1,
                    choices=(1, 2, 3, 4),
                    help="dyadic spatial simulcast layers, low-res first")
    for p in (dp, ep):
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        p.add_argument("--stats", action="store_true",
                       help="print frame count and rate to stderr")
    args = ap.parse_args(argv)
    if args.cmd == "decode":
        _decode(args)
    else:
        _encode(args, ep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
