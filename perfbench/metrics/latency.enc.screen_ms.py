"""Milliseconds per encode request of the program's `encode.screen` self time in the
window: the modular candidate's host screen (`_modular_candidate`); the span less
its child spans (`perfbench/program_spans.py`)."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.screen")
