#!/usr/bin/env python3
"""Integer instruction rates on the card, and a kernel's loops in SASS.

Run from the repo root on a machine with an H100 (not a path the port
runs; a measurement for K5's design, csrc/me_dense.cu):

    python3 tools/sad_rates.py                  # rates, then K5's loops
    python3 tools/sad_rates.py sass LIB.so NAME # the loops of a kernel

Rates: tools/sad_rates.cu, built with nvcc for sm_90a into build/, runs
one CTA of 1024 threads on every SM; each thread applies one operation
to 32 accumulators per step of a loop that is not unrolled (see the .cu).
Printed per operation: the SASS of the loop by opcode (so what a step
compiles to is visible), the SM's cycles from clock64(), and the rates
per SM per clock: steps (lane operations) and issued warp instructions.
The SM clock is the cycles over the CUDA-event time of the launch. After
vabsdiff4.add, the fastest byte SAD, the time K5's pixel pairs at 720p
radius 16 take at its measured rate, 4 pairs an instruction: K5's bound
at that rate.

SASS: `cuobjdump -sass` of a library, the functions whose name holds
NAME, and for each innermost loop (a backward branch whose body holds
no other) its length and its opcodes by count. Without arguments after
the rates it prints K5's loops in the port's kernel library
(build/kernels/libpip_kernels.so, built first if needed).
"""
import collections
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from losslessh264_tpu_torch import _build  # noqa: E402

SRC = os.path.join(ROOT, "tools", "sad_rates.cu")
LIB = os.path.join(ROOT, "build", "sad_rates.so")
CHAINS = 32
THREADS = 1024
# op index of sad_rates.cu's step(): what it computes
OPS = ["__vsadu4 (byte |a-b| summed)", "__vabsdiffu4 (byte |a-b|)",
       "__byte_perm", "__dp4a", "lop3 a^(b&c)", "iadd3 a+b+c", "min",
       "imad a*b+c", "__vsadu4 + c", "vabsdiff4.add (inline PTX)"]
SAD_OP = 9         # the fastest byte SAD: K5's bound at its rate

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def cuobjdump():
    return os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")


def sass_functions(lib, name):
    """{function name: [(address, opcode, operands)]} of the functions of
    `lib` whose mangled name holds `name`."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            cur = funcs.setdefault(fn, []) if name in fn else None
            continue
        m = _LINE.search(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def innermost_loops(code):
    """[(start, end)] address ranges of the loops whose body holds no
    other loop: a branch back to an address before itself (a branch to
    itself, the trap after EXIT, is no loop)."""
    loops = []
    for addr, op, args in code:
        if op.startswith("BRA"):
            t = _TARGET.search(args)
            if t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
    return [(a, b) for a, b in loops
            if not any((c, d) != (a, b) and a <= c and d <= b
                       for c, d in loops)]


def loop_histograms(lib, name):
    """[(function, start, end, Counter of base opcodes)] of every
    innermost loop of the functions named like `name`."""
    rows = []
    for fn, code in sass_functions(lib, name).items():
        for a, b in innermost_loops(code):
            hist = collections.Counter(op.split(".")[0] for addr, op, _ in code
                                       if a <= addr <= b)
            rows.append((fn, a, b, hist))
    return rows


def print_loops(lib, name):
    rows = loop_histograms(lib, name)
    if not rows:
        sys.exit(f"no function of {lib} holds {name!r} with a loop")
    for fn, a, b, hist in rows:
        total = sum(hist.values())
        print(f"SASS {fn[:90]} loop 0x{a:x}..0x{b:x}: {total} instructions: "
              + ", ".join(f"{k} {v}" for k, v in hist.most_common()),
              flush=True)


def build():
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS
                   + ["-Xptxas", "-v", "-o", LIB, SRC], check=True)
    lib = ctypes.CDLL(LIB)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rate_run.argtypes = [I, P, P, I, P, I, P]
    lib.rate_run.restype = I
    return lib


def rates(lib, dev, iters=4096):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(0)
    inp = torch.randint(0, 2 ** 31, (256,), generator=gen,
                        dtype=torch.int64).to(torch.int32).to(dev)
    out = torch.empty(sms * THREADS, dtype=torch.int32, device=dev)
    cyc = torch.empty(sms, dtype=torch.int64, device=dev)
    P = ctypes.c_void_p
    loops = {}
    for fn, _, _, hist in loop_histograms(LIB, "rate_kernel"):
        if sum(hist.values()) > sum(loops.get(fn, {}).values()):
            loops[fn] = hist                  # the step loop: the longest
    for op, what in enumerate(OPS):
        hist = next(h for fn, h in loops.items() if f"ILi{op}E" in fn)

        def run():
            _build.check(lib.rate_run(op, P(inp.data_ptr()),
                                      P(out.data_ptr()), iters,
                                      P(cyc.data_ptr()), sms,
                                      _build.stream(dev)), "rate")
        run()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        cycles = float(cyc.double().mean())
        ms = a.elapsed_time(b)
        steps = THREADS * iters * CHAINS / cycles
        warp_instr = (THREADS // 32) * iters * sum(hist.values()) / cycles
        print(f"rate {what}: loop SASS per step of {CHAINS} "
              + ", ".join(f"{k} {v}" for k, v in hist.most_common())
              + f"; {cycles:.0f} SM cycles, {ms:.4f} ms "
              f"({cycles / ms / 1e3:.0f} MHz); {steps:.1f} lane operations per SM per clock, "
              f"{warp_instr:.2f} warp instructions issued per SM per clock; "
              f"{steps * sms * cycles / ms / 1e9:.1f} T lane operations/s "
              f"on {sms} SMs", flush=True)
        if op == SAD_OP:
            per_s = steps * sms * cycles / ms * 1e3
            pairs = cs.k5_bytes_ops(720, 1280, 16, 4)[1] // 3
            print(f"K5 at 720p radius 16: its {pairs} pixel pairs, 4 to a "
                  f"{what} at this rate, take {pairs / 4 / per_s * 1e3:.5f} "
                  f"ms", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("sad_rates.py needs a CUDA device")
    if len(sys.argv) == 4 and sys.argv[1] == "sass":
        return print_loops(sys.argv[2], sys.argv[3])
    if len(sys.argv) != 1:
        sys.exit("usage: sad_rates.py [sass LIB.so NAME]")
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    rates(build(), dev)
    _build.lib()
    print_loops(_build.LIB_PATH, "me_dense")


if __name__ == "__main__":
    main()
