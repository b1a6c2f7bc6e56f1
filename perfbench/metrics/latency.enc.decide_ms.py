"""Milliseconds per encode request of the program's `encode.decide` self time in the
window: the front end's read-backs of a decision to the host (DC predictor, map
prediction, nnz conditioning), where the host waits for the device; the span less
its child spans (`perfbench/program_spans.py`)."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.decide")
