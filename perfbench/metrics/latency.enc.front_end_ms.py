"""Milliseconds per encode request of the program's `encode.front_end` self time in
the window: the front end `tokens_from_rgb` less its ACS search, decisions and EPF
decision: XYB, quant field, quantisation, CfL, DC, tokens; the span less its child
spans (`perfbench/program_spans.py`)."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.front_end")
