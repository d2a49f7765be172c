#!/usr/bin/env python3
"""Time the torch port's 720p encode (and the intra-heavy part of the
decode) in two checkouts of the repo, in turns, on one NVIDIA GPU.

    python3 tools/encode_ab.py DIR_A DIR_B [--rounds 2]

Each round runs DIR_A, DIR_B, DIR_B, DIR_A (then the next round starts
with DIR_B), every run in a fresh process with the checkout's own
package, kernels and native library (built in the checkout at first
use). A run decodes frames 0-10 of tests/data/synth720p.264 with
TorchDecoder(device="cuda") (frames 0 and 10 are intra-heavy) and
encodes its frames 0-3 with TorchEncoder in configuration A of
tests/data/synth720p_enc_golden.json, whose SHA-256 every frame must
match: once with stage timing off (fps), once with encoder_torch's
StageTimer. It prints one JSON line per run and, at the end, the median
of each number per checkout beside the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = r'''
import hashlib, json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_torch as et

def now():
    torch.cuda.synchronize()
    return time.perf_counter()

data = open("tests/data/synth720p.264", "rb").read()
gold = json.load(open("tests/data/synth720p_enc_golden.json"))["A"]
dev = torch.device("cuda")
frames, decode_ms = [], []
t = now()
for yuv in dt.TorchDecoder(data, device=dev).frames():
    frames.append(tuple(a.cpu().numpy() for a in yuv))
    t1 = now()
    decode_ms.append((t1 - t) * 1e3)
    t = t1
    if len(frames) == 11:
        break
out = {"decode_ms_frame0": decode_ms[0], "decode_ms_frame10": decode_ms[10]}
for timed in (False, True):
    enc = et.TorchEncoder(1280, 720, device=dev, **gold["kwargs"])
    stages = []
    t0 = now()
    for f, g in zip(frames, gold["frames"]):
        if timed:
            enc.stages = et.StageTimer(dev)
        b = enc.encode_frame(*f)
        if hashlib.sha256(b).hexdigest() != g["sha256"]:
            raise SystemExit("encode differs from the golden")
        if timed:
            stages.append(enc.stages.ms)
    wall = now() - t0
    if timed:
        out["idr_stages_ms"] = stages[0]
        out["p_frame_ms"] = [sum(s.values()) for s in stages[1:]]
    else:
        out["encode_fps"] = len(gold["frames"]) / wall
print("RESULT " + json.dumps(out), flush=True)
'''


def run(checkout):
    env = dict(os.environ, CXX="g++", PYTHONPATH=checkout)
    res = subprocess.run([sys.executable, "-c", RUN], cwd=checkout, env=env,
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise SystemExit(f"{checkout}: exit {res.returncode}\n"
                         f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = {args.a: [], args.b: []}
    for r in range(args.rounds):
        first, second = (args.a, args.b) if r % 2 == 0 else (args.b, args.a)
        for d in (first, second, second, first):
            res = run(d)
            results[d].append(res)
            print(json.dumps({"checkout": d, **res}), flush=True)
    for d, runs in results.items():
        med = {k: statistics.median(x[k] for x in runs)
               for k in ("decode_ms_frame0", "decode_ms_frame10",
                         "encode_fps")}
        med["idr_intra_ms"] = statistics.median(
            x["idr_stages_ms"]["intra"] for x in runs)
        med["p_frame_ms"] = statistics.median(
            v for x in runs for v in x["p_frame_ms"])
        print(f"median over {len(runs)} runs of {d}: {json.dumps(med)} "
              f"on {card}", flush=True)


if __name__ == "__main__":
    main()
