"""Spans the benchmark records around its own calls into the program.

A span is (name, start_ns, end_ns) on `time.time_ns()`, the clock that
`torch.profiler`'s events carry, so a span and the device's kernels lie on
one time line. Spans are kept only while a `Recorder` is active (the traced
run); otherwise `span` costs one check.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

_ACTIVE = []  # the Recorder in use, if any


class Recorder:
    """Collects spans while active: `with Recorder() as rec: ...`."""

    def __init__(self):
        self.spans = []

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False


@contextmanager
def span(name: str):
    """Record the time the body takes under `name`."""
    if not _ACTIVE:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        _ACTIVE[-1].spans.append((name, t0, time.time_ns()))
