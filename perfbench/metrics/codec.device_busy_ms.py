"""Milliseconds of the window in which a kernel ran (the union of the kernel
intervals), per round trip: the device work a round trip costs, steadier from run to
run than any wall time."""


def read(trace):
    if not trace.counters.get("units") or not trace.kernels():
        return None
    return trace.busy_ns() / 1e6 / trace.counters["units"]
