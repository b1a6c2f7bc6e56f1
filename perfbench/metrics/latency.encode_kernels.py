"""Kernels that started inside an `encode` span, per encode."""


def read(trace):
    n = trace.span_count("encode")
    k = trace.kernels_in("encode")
    return k / n if n and k else None
