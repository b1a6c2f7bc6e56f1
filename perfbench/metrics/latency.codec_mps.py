"""Megapixels encoded and then decoded (round trips) over the traced window, per
second of it: `codec_mps` in the cells whose runs spread too widely for it to be
gated end to end, where it stands beside their `encode_p95_ms`."""


def read(trace):
    if not trace.counters.get("units"):
        return None
    return trace.counters["megapixels"] / (trace.window_ns / 1e9)
