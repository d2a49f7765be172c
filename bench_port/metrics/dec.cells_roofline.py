"""dec.cells_roofline: percent; the least time the card could take for K11's
work on the profiled frames that take the per-cell route (bytes over 3.35
TB/s or operations over their rate, the larger; harness/workcounts_cells)
over K11's device time in the profiler window (the kernel mc_cells_kernel,
by name). None where no K11 kernel ran."""


def read(t):
    least = getattr(t, "cells_least_s", None)
    device_s = getattr(getattr(t, "profile", None), "cells_kernel_s", None)
    if not least or not device_s:
        return None
    return 100.0 * least / device_s
