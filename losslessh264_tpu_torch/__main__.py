"""Command line of the torch port: every verb of `python -m
losslessh264_tpu`.

    python -m losslessh264_tpu_torch in.264 out.pip     # compress
        [--shards N] [--no-verify] [--stats] [--billing]
    python -m losslessh264_tpu_torch in.pip out.264     # decompress
        [--stats] [--billing]
    python -m losslessh264_tpu_torch roundtrip in.264 [--shards N]
        [--billing]
    python -m losslessh264_tpu_torch parse in.264
    python -m losslessh264_tpu_torch decode in.264 out.yuv
        [--device cuda|cpu] [--stats]
    python -m losslessh264_tpu_torch encode in.yuv WxH out.264
        [--qp 28] [--gop 0] [--bitrate BPS --fps 25] [--cabac] [--aq]
        [--denoise] [--refs 1|2] [--slices N] [--temporal-layers 1-4]
        [--spatial-layers 1-4] [--device cuda|cpu] [--stats]

As in the JAX CLI, the direction of recompression follows the input: a
.pip container (magic "PIPT" or "PIPS") decompresses, anything else
compresses, through the port's own binding of the shared native layer
(native.py); --shards N compresses GOP-sharded. `roundtrip` compresses,
decompresses and compares, `parse` lists the access units without
reconstructing pixels (parse.py). These run no device code, and print
what the JAX CLI prints.
`decode` turns an H.264 stream into raw I420 frames with TorchDecoder
(cropped per the SPS, as the reference decoder writes them). `encode`
reads raw I420 frames of size WxH and writes an H.264 stream with
TorchEncoder, with the flags of `python -m losslessh264_tpu encode`:
with --gop 0 (one IDR, then P frames) it cuts to an IDR at detected
scene changes; --bitrate turns on rate control (a RateControl at
--fps starting at --qp, with the per-row GOM plane); --spatial-layers N
writes N dyadic simulcast layers (SimulcastEncoder, without rate
control: one controller cannot serve several layers).
The default device of decode and encode is cuda, which raises when no
GPU is present. The JAX CLI's `decode --jax` has no counterpart: the
port has one pixel pipeline.
"""
from __future__ import annotations

import argparse
import sys
import time

from . import native


def print_billing(st, in_bytes, out_bytes):
    """Feature | Bench | Ours | delta table of the native ledgers: Bench
    is the bytes the original H.264 spent per feature, Ours the bytes
    the .pip spends; both columns sum to their file sizes. A copy of
    losslessh264_tpu.__main__.print_billing."""
    bench = st.bench or {}
    bill = st.bill or {}
    prior = st.prior or {}
    keys = sorted(set(bench) | set(bill),
                  key=lambda k: -(bench.get(k, 0) + bill.get(k, 0)))
    print(f"  {'feature':<12} {'bench':>10} {'ours':>10} {'delta':>9} "
          f"{'share':>6} {'hit%':>6}")
    tb = to_ = 0.0
    for k in keys:
        b = bench.get(k, 0) / 8.0
        o = bill.get(k, 0) / 8.0
        tb += b
        to_ += o
        tot, hits = prior.get(k, (0, 0))
        hit = f"{100*hits/tot:>5.1f}%" if tot else "     -"
        print(f"  {k:<12} {b:>10.0f} {o:>10.0f} {o-b:>+9.0f} "
              f"{100*o/out_bytes:>5.1f}% {hit}")
    print(f"  {'TOTAL':<12} {tb:>10.0f} {to_:>10.0f} {to_-tb:>+9.0f}")
    if round(tb) != in_bytes or round(to_) != out_bytes:
        print(f"  WARNING: ledger totals ({tb:.0f}/{to_:.0f}) != file sizes "
              f"({in_bytes}/{out_bytes})", file=sys.stderr)


def _parse(path):
    from .parse import DecodeParser
    with open(path, "rb") as fh:
        data = fh.read()
    n = 0
    for au in DecodeParser(data):
        kinds = ",".join(str(t) for t, _ in au.nals)
        print(f"AU {n}: {len(au.annexb)} bytes, nal_types [{kinds}]"
              f"{' IDR' if au.is_idr else ''} "
              f"{au.width}x{au.height}")
        n += 1
    print(f"{n} access units")
    return 0


def _roundtrip(path, args):
    with open(path, "rb") as fh:
        data = fh.read()
    t0 = time.perf_counter()
    if args.shards > 1:
        pip, st = native.compress_sharded(data, args.shards)
    else:
        pip, st = native.compress(data, verify=False)
    t1 = time.perf_counter()
    out, _ = native.decompress(pip)
    t2 = time.perf_counter()
    ok = out == data
    ratio = 100.0 * (1 - len(pip) / len(data))
    print(
        f"{path}: {len(data)} -> {len(pip)} bytes ({ratio:.1f}% saved), "
        f"{st.n_frames} frames, compress {st.n_frames/(t1-t0):.1f} fps, "
        f"decompress {st.n_frames/(t2-t1):.1f} fps, "
        f"bit-exact: {'YES' if ok else 'NO'}"
    )
    if args.billing and st.bill:
        print_billing(st, len(data), len(pip))
    return 0 if ok else 1


def _recompress(args):
    """Compress, or decompress a .pip, by the input's magic bytes."""
    with open(args.input, "rb") as fh:
        data = fh.read()
    if data[:4] in (b"PIPT", b"PIPS"):
        out, st = native.decompress(data)
        if args.stats:
            print(f"decompressed {len(data)} -> {len(out)} bytes, "
                  f"{st.n_frames} frames", file=sys.stderr)
    elif args.shards > 1:
        out, st = native.compress_sharded(data, args.shards,
                                          verify=not args.no_verify)
        if args.stats:
            ratio = 100.0 * (1 - len(out) / len(data))
            print(f"compressed {len(data)} -> {len(out)} bytes "
                  f"({ratio:.1f}% saved), {st.n_frames} frames, "
                  f"{args.shards} shards", file=sys.stderr)
    else:
        out, st = native.compress(data, verify=not args.no_verify)
        if args.stats:
            ratio = 100.0 * (1 - len(out) / len(data))
            print(f"compressed {len(data)} -> {len(out)} bytes "
                  f"({ratio:.1f}% saved), {st.n_frames} frames, "
                  f"{st.n_fallback_slices} fallback slices",
                  file=sys.stderr)
    with open(args.output, "wb") as fh:
        fh.write(out)
    if args.billing and st.bill:
        print_billing(st, len(data), len(out))
    return 0


def _main_recompress(argv):
    """The verbs that take a file first, as the JAX CLI parses them:
    compress / decompress (in out), roundtrip in, parse in."""
    ap = argparse.ArgumentParser(prog="python -m losslessh264_tpu_torch")
    ap.add_argument("input", help="input file (.264 or .pip), 'roundtrip' "
                                  "or 'parse'")
    ap.add_argument("output", nargs="?", help="output file")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip compress-time roundtrip verification")
    ap.add_argument("--stats", action="store_true",
                    help="print stats to stderr")
    ap.add_argument("--billing", action="store_true",
                    help="print per-feature compressed-size billing")
    ap.add_argument("--shards", type=int, default=1,
                    help="compress GOP-sharded into N independent model/"
                         "stream sets")
    args = ap.parse_args(argv)
    if args.input == "parse":
        if not args.output:
            ap.error("parse mode: parse in.264")
        return _parse(args.output)
    if args.input == "roundtrip":
        if not args.output:
            ap.error("roundtrip mode requires an input file")
        return _roundtrip(args.output, args)
    if not args.output:
        ap.error("output file required")
    return _recompress(args)


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
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("decode", "encode"):
        return _main_recompress(argv)
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
