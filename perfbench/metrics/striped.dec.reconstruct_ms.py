"""Milliseconds per round trip of the program's `decode.reconstruct` self time in the
window: every section's pre-EPF reconstruction inside `decode_stream_planes`; the
span less its child spans (`perfbench/program_spans.py`). None where the program
records no such span."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "decode.reconstruct")
