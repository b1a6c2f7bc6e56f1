"""Milliseconds a round trip of the `decode` spans (`decode_bytes_device` and its synchronise) in the window."""


def read(trace):
    if not trace.counters.get("units"):
        return None
    return trace.span_ns("decode") / 1e6 / trace.counters["units"]
