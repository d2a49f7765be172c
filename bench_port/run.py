#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The last line of standard output is the result (one JSON object); the
numbers that decide `correct` are the last lines of standard error. See
bench_port/README.md.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main())
