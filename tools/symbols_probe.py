"""The symbol layer in a recorded decode: passes of 5-12 frames of
tests/data/runs720p.264, a fresh TorchDecoder each, as the benchmark's
dec720p_intra cell decodes them, under the port's tracer (after one
untraced warm-up pass). Prints one JSON line: the frames and frames per
second; per frame, the parse-ahead worker's parse (`dec.symbols.parse`)
and copy-out (`.alloc` + `.export`) and the main thread's wait
(`dec.symbols.wait`), in ms; the frames parsed into planes that held as
large a frame before (`dec.symbols_planes_kept`, where the program
counts it); and the minor page faults a frame, the worker's during the
parse (`dec.symbols_faults`, where counted) and the whole process's.

    python3 tools/symbols_probe.py [--root TREE] [--seconds S] [--seed N]
        [--device cuda|cpu]

--root decodes with the package of another checkout (a parent commit
unpacked beside this one), so that two trees run in turns in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import resource
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from losslessh264_tpu_torch import decoder_torch as dt, trace
    from losslessh264_tpu_torch.parse import split_access_units

    with open(os.path.join(root, "tests", "data", "runs720p.264"),
              "rb") as fh:
        aus = [raw for raw, _ in split_access_units(fh.read())]
    rng = random.Random(args.seed)

    def one_pass():
        data = b"".join(aus[:rng.randint(5, 12)])
        return sum(1 for _ in dt.TorchDecoder(data,
                                              device=args.device).frames())

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    one_pass()
    sync()
    frames = 0
    faults0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
    with trace.recording(sync=False) as rec:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            frames += one_pass()
        sync()
        seconds = time.perf_counter() - t0
    faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults0
    total = rec.total_ms()
    out = {
        "root": root,
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
        "frames": frames,
        "fps": frames / seconds,
        "parse_ms": total.get("dec.symbols.parse", 0.0) / frames,
        "copy_out_ms": (total.get("dec.symbols.alloc", 0.0)
                        + total.get("dec.symbols.export", 0.0)) / frames,
        "wait_ms": total.get("dec.symbols.wait", 0.0) / frames,
        "planes_kept": rec.counters.get("dec.symbols_planes_kept"),
        "dec_frames": rec.counters.get("dec.frames"),
        "worker_faults_per_frame": (
            rec.counters["dec.symbols_faults"] / frames
            if "dec.symbols_faults" in rec.counters else None),
        "process_faults_per_frame": faults / frames,
    }
    if args.device == "cuda":
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
