#!/usr/bin/env python3
"""Write the JAX encode goldens of the configurations that chip_smoke.py
runs with the torch port on the card:

    JAX_PLATFORMS=cpu python tools/gen_enc_golden.py [A B C D E F G]

A and B go to tests/data/synth720p_enc_golden.json, C, D and E to
tests/data/synth720p_enc_golden_cde.json, F to
tests/data/synth720p_enc_golden_f.json, G to
tests/data/synth720p_enc_golden_g.json (all seven by default; a run for
some rewrites only those entries).

The source frames are the first frames of tests/data/synth720p.264 as
NpDecoder decodes them, checked first against the committed NpDecoder
CRCs (tests/data/synth720p_np_crc.json), which the port's card decode
also matches. Each configuration is encoded with JaxEncoder (E: the JAX
SimulcastEncoder; F: the older losslessh264_tpu.encoder.Encoder) on the
CPU; per frame the golden holds the length and
SHA-256 of the frame's Annex-B bytes and the CRC32 of the encoder's
recon Y|U|V after it (E: per layer; F: its reference planes). For C, D,
E and F it also holds the
CRC32 of every picture the JAX package's decoder gives back for the
stream (`decoded_crc32`: NpDecoder, MB-padded; E: SimulcastDecoder, the
display size), and the CPU seconds each configuration took to encode
(`jax_cpu_s`, this host's CPU, compilation included).

  A: qp=28, gop=0, all else default, 1 IDR + 3 P frames. (scene_cut,
     which `encode --gop 0` turns on, would make every frame here an
     IDR: the stream pans, and every 8x8 block of each frame differs
     from the previous frame's by more than the high-motion threshold.)
  B: qp=28, refs=2, cabac=True, 1 IDR + 2 P frames
  C: a live 720p25 stream at a fixed bitrate with AQ and loss recovery:
     qp=28, RateControl(2 Mbps, 25 fps, qp_init=28) (no frame skip),
     aq, gom_rc, bgd, scroll_me, denoise, ltr; mark_ltr() before frame 2
     and recover_from_ltr() before frame 3. Frames 0-3.
  D: MTU-sized slices with dyadic temporal scalability, as an RTP
     sender uses: qp=28, temporal_layers=4, slice_max_bytes=1400, CAVLC.
     Frames 0-4: an IDR, then T3, T2, T3, T1 (frame 4 carries RPLR and
     an MMCO drop).
  E: SimulcastEncoder(1280, 720, spatial_layers=2, qp=28,
     inter_layer=True), frames 0-1.
  F: the older fixed-QP encoder, Encoder(1280, 720, qp=26): an IDR
     (I16x16 only), then 2 P frames with the integer-pel window search
     (ops/me.full_search_sad, radius 16) and no loop filter. Frames 0-2.
     That search holds one [3600, 256, 1089] patch tensor per P frame,
     about 4 GB as float32 on the CPU.
  G: A's settings (qp=28, gop=0, scene_cut off) on frames 0-6 through
     JaxEncoder.encode_frames(frames, batch=3): an IDR, then two runs of
     3 P frames (_p_batch), the second queued before the first's
     entropy is written. The frames are also encoded one encode_frame
     call each, which must give the same bytes; the golden's per-frame
     recon CRC32s come from those calls (a run's recon is not visible
     between its frames), and `run_recon_crc32` is the recon after
     encode_frames, which must equal the last frame's.
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
OUT = {"A": os.path.join(DATA, "synth720p_enc_golden.json"),
       "C": os.path.join(DATA, "synth720p_enc_golden_cde.json")}
OUT["B"] = OUT["A"]
OUT["D"] = OUT["E"] = OUT["C"]
OUT["F"] = os.path.join(DATA, "synth720p_enc_golden_f.json")
OUT["G"] = os.path.join(DATA, "synth720p_enc_golden_g.json")

CONFIGS = {
    "A": {"kwargs": {"qp": 28, "gop": 0}, "frames": 4},
    "B": {"kwargs": {"qp": 28, "refs": 2, "cabac": True}, "frames": 3},
    "C": {"kwargs": {"qp": 28, "aq": True, "gom_rc": True, "bgd": True,
                     "scroll_me": True, "denoise": True, "ltr": True},
          "rc": {"kind": "RateControl", "bitrate_bps": 2_000_000,
                 "fps": 25.0, "qp_init": 28},
          "calls": {"2": ["mark_ltr"], "3": ["recover_from_ltr"]},
          "frames": 4},
    "D": {"kwargs": {"qp": 28, "temporal_layers": 4,
                     "slice_max_bytes": 1400}, "frames": 5},
    "E": {"simulcast": {"spatial_layers": 2, "qp": 28, "inter_layer": True},
          "frames": 2},
    "F": {"older": {"qp": 26}, "frames": 3},
    "G": {"kwargs": {"qp": 28, "gop": 0}, "batch": 3, "frames": 7},
}


def make_encoder(cfg, W, H, encoder_cls, simulcast_cls, ratectl,
                 older_cls=None):
    """The configuration's encoder over the given classes (the golden's
    JSON holds everything it needs); losslessh264_tpu_torch.cases.
    golden_encoder builds the port's the same way."""
    if "older" in cfg:
        return older_cls(W, H, **cfg["older"])
    if "simulcast" in cfg:
        return simulcast_cls(W, H, **cfg["simulcast"])
    kw = dict(cfg["kwargs"])
    if "rc" in cfg:
        spec = dict(cfg["rc"])
        kw["rc"] = getattr(ratectl, spec.pop("kind"))(
            spec.pop("bitrate_bps"), spec.pop("fps"), **spec)
    return encoder_cls(W, H, **kw)


def apply_calls(cfg, enc, i):
    for name in cfg.get("calls", {}).get(str(i), ()):
        getattr(enc, name)()


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


def encode(name, cfg, frames):
    from losslessh264_tpu import (decoder_np, encoder, encoder_jax, ratectl,
                                  simulcast)
    H, W = frames[0][0].shape
    enc = make_encoder(cfg, W, H, encoder_jax.JaxEncoder,
                       simulcast.SimulcastEncoder, ratectl, encoder.Encoder)
    rows, streams = [], []
    for i, f in enumerate(frames[:cfg["frames"]]):
        apply_calls(cfg, enc, i)
        if "simulcast" in cfg:
            parts = enc.encode_frame_layers(*f)
            streams.append(parts)
            rows.append({"layers": [
                {"bytes": len(p), "sha256": hashlib.sha256(p).hexdigest(),
                 "recon_crc32": recon_crc(e.recon)}
                for p, e in zip(parts, enc.encs)]})
        else:
            data = enc.encode_frame(*f)
            streams.append(data)
            rows.append({"bytes": len(data),
                         "sha256": hashlib.sha256(data).hexdigest(),
                         "recon_crc32": recon_crc(
                             enc.ref if "older" in cfg else enc.recon)})
            if name not in ("A", "B", "F"):
                rows[-1]["is_ref"] = bool(enc._cur_is_ref)
    if "batch" in cfg:
        return rows, run_frames(cfg, frames, rows, encoder_jax.JaxEncoder)
    if name in ("A", "B"):
        return rows, None
    if "simulcast" in cfg:
        layers = [b"".join(s[li] for s in streams)
                  for li in range(len(streams[0]))]
        pics = simulcast.SimulcastDecoder(layers, error_concealment=False)
    else:
        pics = decoder_np.NpDecoder(b"".join(streams),
                                    error_concealment=False)
    return rows, [recon_crc(p) for p in pics.frames()]


def run_frames(cfg, frames, rows, encoder_cls):
    """The recon CRC32 after encode_frames(frames, batch) on a fresh
    encoder, whose bytes must equal the per-frame `rows`."""
    H, W = frames[0][0].shape
    enc = encoder_cls(W, H, **cfg["kwargs"])
    out = enc.encode_frames(frames[:cfg["frames"]], batch=cfg["batch"])
    got = [hashlib.sha256(d).hexdigest() for d in out]
    if got != [r["sha256"] for r in rows]:
        raise SystemExit("encode_frames(batch=%d) differs from the "
                         "per-frame encodes" % cfg["batch"])
    crc = recon_crc(enc.recon)
    if crc != rows[-1]["recon_crc32"]:
        raise SystemExit("the recon after encode_frames differs from the "
                         "last per-frame encode's")
    return crc


def main(argv):
    names = argv or list(CONFIGS)
    frames = source_frames(max(CONFIGS[k]["frames"] for k in names))
    H, W = frames[0][0].shape
    outs = {}
    for path in set(OUT[k] for k in names):
        outs[path] = (json.load(open(path)) if os.path.exists(path) else {})
        outs[path]["source"] = {"stream": "tests/data/synth720p.264",
                                "decoder": "NpDecoder", "width": W,
                                "height": H}
    for name in names:
        cfg = CONFIGS[name]
        t0 = time.perf_counter()
        rows, decoded = encode(name, cfg, frames)
        dt = time.perf_counter() - t0
        entry = {k: v for k, v in cfg.items() if k != "frames"}
        entry["frames"] = rows
        if "batch" in cfg:
            entry["run_recon_crc32"] = decoded
        elif decoded is not None:
            entry["decoded_crc32"] = decoded
            entry["jax_cpu_s"] = round(dt, 1)
        outs[OUT[name]][name] = entry
        print(f"{name}: {len(rows)} frames ({dt:.1f} s on the CPU)",
              flush=True)
    for path, out in outs.items():
        with open(path, "w") as fh:
            json.dump(out, fh, indent=1)
            fh.write("\n")
        print("wrote", path)


if __name__ == "__main__":
    main(sys.argv[1:])
