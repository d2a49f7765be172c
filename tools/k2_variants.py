#!/usr/bin/env python3
"""Write diagnostic builds of K2 (csrc/deblock.cu), each with one part
of the per-MB step taken out, for tools/kernel_ab.py (k2) to time beside the
whole kernel (run from the repo root):

    python3 tools/k2_variants.py
    python3 tools/kernel_ab.py k2 build/k2_noedge.cu build/k2_nofence.cu \\
        build/k2_noldcg.cu

  noedge   the edge filters return at once: no edge arithmetic
  nofence  publish() stores the progress flag without __threadfence
  noldcg   the rows above are read with plain loads, not through L2

They are not exact (kernel_ab.py reports that and times them all the same):
their times split a step of the MB chain into its parts.
"""
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "losslessh264_tpu_torch", "csrc", "deblock.cu")
OUT = os.path.join(ROOT, "build")

VARIANTS = {
    "noedge": [("  if (!filt) return;", "  return;", 2)],
    "nofence": [("  __threadfence();\n  __syncwarp();",
                 "  __syncwarp();", 1)],
    "noldcg": [("__ldcg(", "*(", 2)],
}


def main():
    src = open(SRC).read()
    os.makedirs(OUT, exist_ok=True)
    for name, edits in VARIANTS.items():
        text = src
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"{name}: {old!r} occurs "
                                 f"{text.count(old)} times, not {count}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"k2_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        print(path)


if __name__ == "__main__":
    main()
