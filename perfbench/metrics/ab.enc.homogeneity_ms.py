"""Milliseconds per point of the program's `encode.homogeneity` self time in the
window: the thesis's homogeneity hooks inside the AC-strategy search: the similarity
statistics, the hook-B factor and the hook-A partition; the span less its child
spans (`perfbench/program_spans.py`). None where the program records no such span."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.homogeneity")
