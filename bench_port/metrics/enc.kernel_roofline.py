"""enc.kernel_roofline: percent; the least time the card could take for the
profiled frames' stages' work (bytes over 3.35 TB/s or operations over
their rate, the larger; harness/workcounts) over the device time of
every kernel in the profiler window."""
from harness.readers import kernel_roofline_pct


def read(t):
    return kernel_roofline_pct(t)
