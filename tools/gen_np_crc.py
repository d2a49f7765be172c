"""Regenerate tests/data/synth720p_np_crc.json: per-frame CRC32 of the
numpy oracle's (decoder_np.NpDecoder) YUV output over the in-repo
streams, for checks that cannot afford to re-run the oracle.

Usage: python tools/gen_np_crc.py

Rows: all 25 frames of tests/data/synth720p.264 and frames 0-15 of
tests/data/walk_analog.264. The CRC formula is the one of
tests/test_decode_parity.py: zlib.crc32(Y.tobytes() + U.tobytes() +
V.tobytes()) over the uncropped planes NpDecoder yields. NpDecoder is
itself validated bit-exactly against the reference decoder
(tests/data/ref_yuv_crc.json). Takes several minutes on one CPU core.
"""
import json
import os
import sys
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATA = os.path.join(os.path.dirname(__file__), "..", "tests", "data")
OUT = os.path.join(DATA, "synth720p_np_crc.json")
STREAMS = (("synth720p", "synth720p.264", 25),
           ("walk_analog", "walk_analog.264", 16))


def stream_crcs(path, n_frames):
    from losslessh264_tpu import decoder_np
    dec = decoder_np.NpDecoder(open(path, "rb").read())
    crcs = []
    shape = None
    for Y, U, V in dec.frames():
        crcs.append(zlib.crc32(Y.tobytes() + U.tobytes() + V.tobytes()))
        shape = list(Y.shape)
        if len(crcs) == n_frames:
            break
    return {"stream": os.path.basename(path), "frames": len(crcs),
            "luma_shape": shape, "crc32": crcs}


def main():
    out = {}
    for name, fname, n in STREAMS:
        out[name] = stream_crcs(os.path.join(DATA, fname), n)
        print(name, out[name]["frames"], "frames", flush=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
