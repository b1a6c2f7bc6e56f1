"""Milliseconds per round trip of the program's `decode.stitch` self time in the
window: the stitch of each run of VarDCT sections: the planes' concatenation, one
EPF pass over the run and the colour transform; the span less its child spans
(`perfbench/program_spans.py`). None where the program records no such span."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "decode.stitch")
