"""The process's start on the host's perf_counter clock, so that set-up
counts from process start, interpreter and imports included; and what
the host did in a window (collections, CPU time), which the runs print
beside their numbers."""
from __future__ import annotations

import gc
import os
import resource
import time


def process_start():
    """perf_counter() at the moment this process was created, from
    /proc/self/stat's start time and /proc/uptime (10 ms ticks); where
    /proc cannot be read, the moment of this call."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            stat = fh.read()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        # the fields after the command name, which may hold spaces
        fields = stat[stat.rindex(")") + 2:].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    age = uptime - started
    return now - age if 0 <= age < 3600 else now


class GcClock:
    """The interpreter's garbage collections while it is on: how many of
    each generation and the milliseconds they took (gc.callbacks)."""

    def __init__(self):
        self.ms = 0.0
        self.longest_ms = 0.0
        self.counts = [0, 0, 0]
        self._t = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            dt = (time.perf_counter() - self._t) * 1e3
            self.ms += dt
            self.longest_ms = max(self.longest_ms, dt)
            self.counts[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def line(self):
        return (f"garbage collections in the window: {self.counts} "
                f"(generations 0-2), {self.ms:.1f} ms, the longest "
                f"{self.longest_ms:.1f} ms")



class HostClock:
    """The process's CPU seconds while it is on: a window whose frames
    swing while the CPU time stays near the wall time is one in which
    the host ran the same work at another speed."""

    def __enter__(self):
        self._r = resource.getrusage(resource.RUSAGE_SELF)
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        r = resource.getrusage(resource.RUSAGE_SELF)
        self.wall_s = time.perf_counter() - self._t
        self.user_s = r.ru_utime - self._r.ru_utime
        self.system_s = r.ru_stime - self._r.ru_stime

    def line(self):
        return (f"host in the window: {self.wall_s:.2f} s, the process's "
                f"CPU {self.user_s:.2f} s user and {self.system_s:.2f} s "
                f"system (all its threads)")
