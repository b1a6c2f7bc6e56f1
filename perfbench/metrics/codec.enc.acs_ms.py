"""Milliseconds per round trip of the program's `encode.acs` self time in the
window: the AC-strategy search (`search_acs`); the span less its child spans
(`perfbench/program_spans.py`)."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.acs")
