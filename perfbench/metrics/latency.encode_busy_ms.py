"""Milliseconds of an encode span in which a kernel ran (the union of the kernel
intervals inside the `encode` spans), per encode: the device work of one request."""


def read(trace):
    n = trace.span_count("encode")
    busy = trace.busy_in_ns("encode")
    return busy / 1e6 / n if n and busy else None
