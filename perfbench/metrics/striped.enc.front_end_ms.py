"""Milliseconds per round trip of the program's `encode.front_end` self time in the
window: every stripe's front end `tokens_from_rgb` less its ACS search, decisions
and EPF decision; the span less its child spans (`perfbench/program_spans.py`). None
where the program records no such span."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.front_end")
