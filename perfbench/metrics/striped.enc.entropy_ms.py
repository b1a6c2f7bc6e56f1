"""Milliseconds per round trip of the program's `encode.entropy` self time in the
window: every stripe's `_entropy_encode`: padding, histograms, clustering, tables,
kernel rows, the B3 launch and its overflow check; the span less its child spans
(`perfbench/program_spans.py`). None where the program records no such span."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.entropy")
