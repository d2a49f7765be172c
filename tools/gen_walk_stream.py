"""Encode the walk stand-in: a synthetic camera walking forward through
four textured scenes (640x352), at the upstream walk.264's length (1331
frames, walk.stats:796-945) and close to its size (8,178,983 bytes), with
the port's TorchEncoder (fixed QP, an IDR every 100 frames, one
reference, CAVLC, deblocking on, the encoder's scene-change IDRs off).

Usage: python tools/gen_walk_stream.py --qp 22 [--qp 23 ...]
           [--frames 1331] [--device cpu] [--workers 7] [--out DIR]

The motion is a walk's: the scene grows from a vanishing point a little
each frame (every block moves by its own distance from that point, as
parallax and forward motion move it in footage), a step's sway and bob,
and sensor noise in every frame; a scene cut every 280 frames. Each GOP
is encoded by a fresh encoder (GOPs in `--workers` processes at once),
and the GOPs are joined with the SPS and PPS once, at the start: the
bytes of one encoder over the whole stream (its state starts anew at each
IDR). Each --qp writes <DIR>/walk_qp<qp>.264 and prints its bytes; the
benchmark's copy is bench_port/data/walk_analog_1331.264 (qp 22).
"""
import argparse
import hashlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 640, 352
GOP = 100
SCENE = 280        # frames between scene cuts
ZOOM = 1.003       # the scene's growth a frame as the camera walks on
CANVAS = 1.6       # the first frame of a scene sees this many frame widths


def smooth(rng, shape, cell, lo, hi):
    """Noise in [lo, hi) on a grid `cell` samples apart, bilinear between:
    shapes of about `cell` samples."""
    gh, gw = shape[0] // cell + 2, shape[1] // cell + 2
    g = rng.uniform(lo, hi, (gh, gw))
    y = np.arange(shape[0]) / cell
    x = np.arange(shape[1]) / cell
    return bilinear(g, *np.meshgrid(y, x, indexing="ij"))


def bilinear(img, y, x):
    """img sampled at the (float) positions y, x, clamped to its edge."""
    y = np.clip(y, 0, img.shape[0] - 1.001)
    x = np.clip(x, 0, img.shape[1] - 1.001)
    y0, x0 = y.astype(np.int64), x.astype(np.int64)
    fy, fx = y - y0, x - x0
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)


def scene(seed):
    """A scene's luma and chroma canvases (float): large and small shapes
    and a fine grain fixed to the scene."""
    rng = np.random.RandomState(seed)
    ch, cw = int(H * CANVAS) + 64, int(W * CANVAS) + 64
    luma = (smooth(rng, (ch, cw), 64, 30, 200)
            + smooth(rng, (ch, cw), 12, -30, 30)
            + smooth(rng, (ch, cw), 3, -12, 12)
            + rng.uniform(-6, 6, (ch, cw)))
    chroma = [smooth(rng, (ch // 2, cw // 2), 24, 80, 176)
              + smooth(rng, (ch // 2, cw // 2), 6, -12, 12)
              for _ in range(2)]
    return luma, chroma


def frames(n, first=0):
    """Frames first..n-1 (Y, U, V uint8) of the walk: in each scene the view
    narrows by ZOOM a frame about a vanishing point that drifts with the
    walk's sway, and each frame adds its own sensor noise."""
    scenes = [scene(s) for s in range(4)]
    yy, xx = np.meshgrid(np.arange(H) - H / 2, np.arange(W) - W / 2,
                         indexing="ij")
    cy, cx = np.meshgrid(np.arange(H // 2) - H / 4,
                         np.arange(W // 2) - W / 4, indexing="ij")
    for i in range(first, n):
        luma, chroma = scenes[(i // SCENE) % 4]
        t = i % SCENE
        view = CANVAS / ZOOM ** t          # frame widths seen
        sway = 6.0 * np.sin(2 * np.pi * i / 36)
        bob = 3.0 * abs(np.sin(np.pi * i / 18))
        oy = luma.shape[0] / 2 + bob
        ox = luma.shape[1] / 2 + sway + 0.08 * t
        noise = np.random.RandomState(10_000 + i)
        Y = bilinear(luma, oy + yy * view, ox + xx * view)
        Y = Y + noise.uniform(-2, 2, Y.shape)
        uv = [bilinear(c, oy / 2 + cy * view, ox / 2 + cx * view)
              + noise.uniform(-1, 1, cy.shape) for c in chroma]
        yield tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                    for p in (Y, *uv))


def nal_kinds(data):
    """[(offset of the start code, nal_unit_type)] of an Annex-B buffer."""
    out, i = [], data.find(b"\x00\x00\x01")
    while i >= 0:
        start = i - 1 if i and data[i - 1] == 0 else i
        out.append((start, data[i + 3] & 31))
        i = data.find(b"\x00\x00\x01", i + 3)
    return out


def encode_gop(job):
    """The bytes of frames first..end-1 (first an IDR) from a fresh
    encoder, its leading SPS and PPS dropped unless first is 0."""
    qp, first, end, device = job
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    pics = list(frames(end, first))
    enc = TorchEncoder(W, H, qp=qp, gop=GOP, device=device)
    out = b"".join(enc.encode_frames(pics))
    if first:
        units = nal_kinds(out)
        lead = next(s for s, kind in units if kind not in (7, 8))
        if [k for s, k in units if s < lead] != [7, 8]:
            raise SystemExit(f"GOP at {first}: leading NAL units "
                             f"{units[:3]}")
        out = out[lead:]
    print(f"qp {qp}: GOP at {first}, {len(out)} bytes", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--qp", type=int, action="append", required=True)
    ap.add_argument("--frames", type=int, default=1331)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    jobs = [(qp, a, min(a + GOP, args.frames), args.device)
            for qp in args.qp for a in range(0, args.frames, GOP)]
    t0 = time.time()
    if args.workers > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
            parts = pool.map(encode_gop, jobs, chunksize=1)
    else:
        parts = [encode_gop(j) for j in jobs]
    for qp in args.qp:
        out = b"".join(p for j, p in zip(jobs, parts) if j[0] == qp)
        path = os.path.join(args.out, f"walk_qp{qp}.264")
        with open(path, "wb") as f:
            f.write(out)
        print(f"{path}: qp {qp}, {len(out)} bytes, {args.frames} frames, "
              f"sha256 {hashlib.sha256(out).hexdigest()}", flush=True)
    print(f"{time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
