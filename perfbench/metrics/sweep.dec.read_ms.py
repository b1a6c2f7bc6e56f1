"""Milliseconds per point of the program's `decode.read` self time in the window:
the container parse, bucket layout and uploads; the span less its child spans
(`perfbench/program_spans.py`)."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "decode.read")
