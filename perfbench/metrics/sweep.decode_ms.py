"""Milliseconds a point of the `decode` spans (`decode_bytes_grid_stacked` and its synchronise) in the window."""


def read(trace):
    if not trace.counters.get("units"):
        return None
    return trace.span_ns("decode") / 1e6 / trace.counters["units"]
