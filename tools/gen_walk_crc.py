"""Write bench_port/reference/crc/walk_analog_1331.json: the numpy
reference decoder's (bench_port/reference/decoder_np.py, a frozen copy of
NpDecoder) CRC32 of every frame of bench_port/data/walk_analog_1331.264
(tools/gen_walk_stream.py), for the benchmark's GOP-pass cell.

Usage: python tools/gen_walk_crc.py [--workers N]

Every GOP starts at an IDR, so each is decoded alone (its clip carries
the stream's parameter sets, bench_port/harness/gops.py), one process per
GOP, N at a time (default 5). The CRC formula is
the one of tests/data/synth720p_np_crc.json: zlib.crc32 of Y|U|V, the
uncropped uint8 planes NpDecoder yields.
"""
import argparse
import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_port")
STREAM = os.path.join(BENCH, "data", "walk_analog_1331.264")
OUT = os.path.join(BENCH, "reference", "crc", "walk_analog_1331.json")


def gop_crcs(job):
    first, clip = job
    sys.path.insert(0, BENCH)
    from reference import check, decoder_np
    t0 = time.time()
    crcs, shape = [], None
    for Y, U, V in decoder_np.NpDecoder(clip).frames():
        crcs.append(check.frame_crc(Y, U, V))
        shape = list(Y.shape)
    print(f"GOP at {first}: {len(crcs)} frames in {time.time() - t0:.0f} s",
          flush=True)
    return first, crcs, shape


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, BENCH)
    from harness import gops
    with open(STREAM, "rb") as fh:
        data = fh.read()
    jobs = gops.gop_clips(data)
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        done = sorted(pool.map(gop_crcs, jobs, chunksize=1))
    crcs = []
    for first, c, shape in done:
        if first != len(crcs):
            raise SystemExit(f"GOP at {first} follows {len(crcs)} frames")
        crcs += c
    out = {"stream": os.path.basename(STREAM), "frames": len(crcs),
           "luma_shape": shape, "gop_starts": [f for f, _, _ in done],
           "crc32": crcs,
           "made_by": "NpDecoder (bench_port/reference/decoder_np.py, a "
                      "frozen copy of the repo's numpy reference decoder), "
                      "each GOP decoded alone from its IDR with the "
                      "stream's parameter sets in front, over the "
                      "uncropped Y|U|V planes it yields; "
                      "tools/gen_walk_crc.py"}
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(f"{len(crcs)} frames -> {OUT}")


if __name__ == "__main__":
    main()
