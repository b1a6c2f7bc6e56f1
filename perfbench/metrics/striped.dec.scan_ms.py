"""Milliseconds per round trip of the program's `decode.scan` self time in the window:
both rANS phases (B1) of every section; the span less its child spans
(`perfbench/program_spans.py`). None where the program records no such span."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "decode.scan")
