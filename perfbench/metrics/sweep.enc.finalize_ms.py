"""Milliseconds per point of the program's `encode.finalize` self time in the
window: the finalize: buckets to the host, mode pick, container assembly; the span
less its child spans (`perfbench/program_spans.py`)."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.finalize")
