"""Milliseconds a round trip of the `encode` spans (`encode_image`) in the window."""


def read(trace):
    if not trace.counters.get("units"):
        return None
    return trace.span_ns("encode") / 1e6 / trace.counters["units"]
