#!/usr/bin/env python3
"""Write tests/data/synth720p_enc_golden.json: JaxEncoder's bytes and
recon for the encode configurations that chip_smoke.py runs with the
torch port's TorchEncoder on the card.

    JAX_PLATFORMS=cpu python tools/gen_enc_golden.py

The source frames are the first frames of tests/data/synth720p.264 as
NpDecoder decodes them, checked first against the committed NpDecoder
CRCs (tests/data/synth720p_np_crc.json), which the port's card decode
also matches. Each configuration is encoded with JaxEncoder on the CPU;
per frame the golden holds the length and SHA-256 of the frame's
Annex-B bytes and the CRC32 of the encoder's recon Y|U|V after it.

  A: qp=28, gop=0, all else default, 1 IDR + 3 P frames. (scene_cut,
     which `encode --gop 0` turns on, would make every frame here an
     IDR: the stream pans, and every 8x8 block of each frame differs
     from the previous frame's by more than the high-motion threshold.)
  B: qp=28, refs=2, cabac=True, 1 IDR + 2 P frames
"""
import hashlib
import json
import os
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "tests", "data")
OUT = os.path.join(DATA, "synth720p_enc_golden.json")

CONFIGS = {
    "A": {"kwargs": {"qp": 28, "gop": 0}, "frames": 4},
    "B": {"kwargs": {"qp": 28, "refs": 2, "cabac": True}, "frames": 3},
}


def source_frames(n):
    """The first n frames of synth720p.264 (NpDecoder), CRC-checked."""
    from losslessh264_tpu import decoder_np
    with open(os.path.join(DATA, "synth720p.264"), "rb") as fh:
        data = fh.read()
    gold = json.load(open(os.path.join(DATA, "synth720p_np_crc.json")))
    frames = []
    for i, yuv in enumerate(decoder_np.NpDecoder(data).frames()):
        if i == n:
            break
        crc = zlib.crc32(b"".join(np.asarray(p).tobytes() for p in yuv))
        if crc != gold["synth720p"]["crc32"][i]:
            raise SystemExit(f"source frame {i}: CRC {crc} differs from the "
                             "committed NpDecoder golden")
        frames.append(tuple(np.ascontiguousarray(p) for p in yuv))
    return frames


def recon_crc(recon):
    return zlib.crc32(b"".join(np.asarray(p).tobytes() for p in recon))


def main():
    from losslessh264_tpu import encoder_jax
    n = max(c["frames"] for c in CONFIGS.values())
    frames = source_frames(n)
    H, W = frames[0][0].shape
    out = {"source": {"stream": "tests/data/synth720p.264",
                      "decoder": "NpDecoder", "width": W, "height": H}}
    for name, cfg in CONFIGS.items():
        t0 = time.perf_counter()
        enc = encoder_jax.JaxEncoder(W, H, **cfg["kwargs"])
        rows = []
        for f in frames[:cfg["frames"]]:
            data = enc.encode_frame(*f)
            rows.append({"bytes": len(data),
                         "sha256": hashlib.sha256(data).hexdigest(),
                         "recon_crc32": recon_crc(enc.recon)})
        out[name] = {"kwargs": cfg["kwargs"], "frames": rows}
        print(f"{name}: {[r['bytes'] for r in rows]} bytes "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print("wrote", OUT)


if __name__ == "__main__":
    main()
