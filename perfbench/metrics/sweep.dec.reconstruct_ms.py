"""Milliseconds per point of the program's `decode.reconstruct` self time in the
window: the reconstruction of each stream (`_reconstruct_stream`); the span less its
child spans (`perfbench/program_spans.py`)."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "decode.reconstruct")
