"""Milliseconds an encode request of the `encode` spans (`encode_image`) in the
window, on average."""


def read(trace):
    n = trace.span_count("encode")
    return trace.span_ns("encode") / 1e6 / n if n else None
