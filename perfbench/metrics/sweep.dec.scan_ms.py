"""Milliseconds per point of the program's `decode.scan` self time in the window:
both rANS phases (B2 over the row) and the phase-B contexts; the span less its child
spans (`perfbench/program_spans.py`)."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "decode.scan")
