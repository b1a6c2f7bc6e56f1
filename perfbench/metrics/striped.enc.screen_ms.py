"""Milliseconds per round trip of the program's `encode.screen` self time in the
window: the whole-frame modular pre-screen that `encode_image_striped` runs on the
host frame before the stripes; the span less its child spans
(`perfbench/program_spans.py`). None where the program records no such span."""

from perfbench import program_spans


def read(trace):
    return program_spans.self_ms_per_unit(trace, "encode.screen")
