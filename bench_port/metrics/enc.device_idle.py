"""enc.device_idle: percent of the traced profiler window in which no
kernel, copy or set ran on the device (1 minus the busy share)."""
from harness.readers import device_idle_pct


def read(t):
    return device_idle_pct(t)
