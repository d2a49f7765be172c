"""One run of one cell: set-up, a measured window, the check of what the
window produced, and the result line.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The driver of the cell's traffic (drivers/<driver>.py) does the set-up,
the window and the check, and returns an Outcome. This module turns it
into the last line of standard output, after the numbers compared on the
last lines of standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "losslessh264_tpu")


@dataclass
class Check:
    """A number compared and its limit: the run is correct only if the
    number is at most the limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self):
        return self.value <= self.limit


@dataclass
class Ctx:
    root: str
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    fault: str | None = None    # a planted fault (the benchmark's tests)

    def sync(self):
        """Wait for the device (nothing to wait for on the CPU)."""
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()


@dataclass
class Outcome:
    """What a driver hands back. `e2e` holds the end-to-end values the
    window measured (setup_s is added here); `trace` what the per-layer
    readers read (None in an untraced run); `profile` the profiler window
    of a traced run."""
    t_window_start: float
    frames: int
    window_s: float
    attempted: int
    failed: int
    e2e: dict
    checks: list
    memory_peak_bytes: int
    trace: object = None
    profile: object = None
    notes: list = field(default_factory=list)


@dataclass
class TraceData:
    """What a per-layer reader reads. spans: ms per label summed over the
    spanned window; frames: that window's frames; profile: the profiler
    window (trace.Profile); least_s: the least seconds the card could
    take for the profiler window's stages' work (workcounts); counters:
    the program's own counters read after the window."""
    spans: dict
    frames: int
    profile: object = None
    least_s: float | None = None
    counters: dict = field(default_factory=dict)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(ctx, t_process):
    """Run the cell and return (result dict, checks)."""
    import torch
    out = ctx.cell.driver().run(ctx)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{', '.join(bad)}")
    setup_s = out.t_window_start - t_process
    metrics = {}
    if not ctx.trace:
        values = dict(out.e2e, setup_s=setup_s)
        for m in ctx.cell.end_to_end:
            if m["name"] not in values:
                raise SystemExit(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in ctx.cell.per_layer:
            v = ctx.cell.reader(m["name"])(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if ctx.device == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": ctx.cell.chips}
    else:   # the benchmark's own tests on the CPU
        device = {"platform": "cpu", "kind": "cpu", "count": 1}
    device["memory_peak_bytes"] = int(out.memory_peak_bytes)
    result = {"correct": all(c.ok for c in out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device}
    if ctx.trace and out.profile is not None:
        device["busy_s"] = out.profile.busy_s
        device["window_s"] = out.profile.window_s
        result["breakdown"] = {"device_ops": out.profile.ops,
                               "idle_gaps": out.profile.idle}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    return result, out


def main(argv=None):
    from . import clock
    t_process = clock.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = spec.Cell(root, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    # numpy's generators take seeds of 0 or more
    ctx = Ctx(root=root, cell=cell, seed=args.seed % 2 ** 63,
              seconds=args.seconds,
              trace=bool(args.trace))
    card = card_line()
    print(f"card: {card or torch.cuda.get_device_name(0)}", file=sys.stderr,
          flush=True)
    result, out = run_cell(ctx, t_process)
    if card:
        result["device"]["power_limit"] = card.split(",")[-1].strip()
    for line in out.notes:
        print(line, flush=True)
    print(f"frames: {out.frames} in {out.window_s} s "
          f"({'traced' if ctx.trace else 'untraced'} window), "
          f"attempted {out.attempted}, failed {out.failed}", flush=True)
    for c in out.checks:
        print(f"check {c.name}: {c.value} limit {c.limit} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
