"""Stage spans of the codec, on the clock of `torch.profiler`.

A span is one stage of a request, recorded as `Span(name, start_ns, end_ns,
span_id, parent_id, request_id)` on `time.time_ns()`: the clock that
torch.profiler's events carry, so the program's spans and the device's
kernels lie on one time line.

- The parent is the innermost span open on the thread; a span with none is
  a root and starts a new request, unless it is given the id of the request
  it belongs to (`bind`: the finalize of an `*_async` dispatch carries the
  dispatch's id, so a round trip's spans share one id).
- A span opened directly inside an open span of the same name records
  nothing: an entry point that calls another is one span.
- Tracing is on while a torch.profiler session is active, or while a
  `Recorder` is entered. Otherwise `span()` returns one shared no-op object
  after that check.
- Spans recorded under the profiler go to a bounded module buffer
  (`spans_between`, `drain`, `dropped`); those under a Recorder go to the
  Recorder. A full buffer counts what it drops.

Nothing here emits profiler annotations (`record_function`, NVTX): they cost
time even with the profiler off, and a device trace would count them with
the kernels.

    with span("encode.entropy"):
        ...

    @traced("encode.front_end")
    def tokens_from_rgb(...): ...
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

CAPACITY = 1 << 17  # spans the module buffer holds: ~10x a traced 51 s sweep window
SPAN_TID = 0x7FFF_0000  # the Chrome trace track of the spans


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int | None
    request_id: int


class Buffer:
    """Spans in the order they closed, at most `capacity`; `dropped` counts
    the spans that found it full. Kept as plain tuples, made `Span`s when
    read."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.raw = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, s: tuple):
        with self._lock:
            if len(self.raw) < self.capacity:
                self.raw.append(s)
            else:
                self.dropped += 1

    @property
    def spans(self) -> list:
        return [Span._make(s) for s in self.raw]


class Recorder(Buffer):
    """Turns tracing on and collects the spans while entered:
    `with Recorder() as rec: ...; rec.spans`."""

    def __enter__(self):
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self)
        return False


_BUFFER = Buffer()
_RECORDERS = []
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)
_LOCAL = threading.local()


class _Profiler:
    """Stands for `torch.autograd.profiler` until the first check imports
    it: `_PROFILER._is_profiler_enabled` says whether a torch.profiler
    session is active."""

    def __getattr__(self, attr):
        global _PROFILER
        from torch.autograd import profiler

        if not hasattr(profiler, "_is_profiler_enabled"):
            profiler = _Enabled()
        _PROFILER = profiler
        return getattr(profiler, attr)


class _Enabled:
    """The same check where the module has no such flag."""

    @property
    def _is_profiler_enabled(self) -> bool:
        import torch

        return torch.autograd._profiler_enabled()


_PROFILER = _Profiler()


def tracing() -> bool:
    """Whether spans are recorded now."""
    return bool(_RECORDERS or _PROFILER._is_profiler_enabled)


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "request", "stack", "start", "span_id", "parent_id")

    def __enter__(self):
        stack = self.stack
        if stack:
            parent = stack[-1]
            self.parent_id = parent.span_id
            if self.request is None:
                self.request = parent.request
        else:
            self.parent_id = None
            if self.request is None:
                self.request = next(_REQUESTS)
        self.span_id = next(_IDS)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        (_RECORDERS[-1] if _RECORDERS else _BUFFER).add(
            (self.name, self.start, end, self.span_id, self.parent_id, self.request))
        return False


def span(name: str, request: int | None = None):
    """A context manager that records the body as a span `name` while
    tracing is on; `request` sets the request id of a root."""
    if not (_RECORDERS or _PROFILER._is_profiler_enabled):
        return _OFF
    stack = _stack()
    if stack and stack[-1].name == name:
        return _OFF
    sp = _Open()
    sp.name, sp.request, sp.stack = name, request, stack
    return sp


def traced(name: str):
    """Decorator form of `span`: each call of the function is a span."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return run

    return wrap


def bind(name: str, fn):
    """fn, to be called later as a span `name` of the request open on the
    thread now (a root of that request when nothing is open at the call)."""
    stack = _stack()
    request = stack[-1].request if stack else None

    def run(*args, **kwargs):
        with span(name, request):
            return fn(*args, **kwargs)

    return run


def spans_between(t0_ns: int, t1_ns: int) -> list:
    """The module buffer's spans that lie inside [t0_ns, t1_ns]."""
    return [Span._make(s) for s in _BUFFER.raw if s[1] >= t0_ns and s[2] <= t1_ns]


def dropped() -> int:
    """Spans the module buffer dropped since the last `drain`."""
    return _BUFFER.dropped


def drain() -> list:
    """Take every span out of the module buffer and reset its drop count."""
    with _BUFFER._lock:
        out, _BUFFER.raw, _BUFFER.dropped = _BUFFER.raw, [], 0
    return [Span._make(s) for s in out]


def add_to_chrome_trace(path: str, spans, n_dropped: int = 0) -> str:
    """Add `spans` to the torch.profiler Chrome trace at `path` as a track
    of their own in the process's group, on the trace's time base (an
    event's `ts` is in microseconds after `baseTimeNanoseconds`). A trace
    without that base gets a `spans.json` beside it instead, in
    nanoseconds of `time.time_ns()`. Returns the file written."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds")
    if base is None:
        out = os.path.join(os.path.dirname(path), "spans.json")
        with open(out, "w") as f:
            json.dump({"clock": "time.time_ns", "dropped": n_dropped, "spans": [s._asdict() for s in spans]}, f)
        return out
    pid = os.getpid()
    label = "program spans" + (f" ({n_dropped} dropped)" if n_dropped else "")
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID, "args": {"name": label}}]
    for s in spans:
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": SPAN_TID,
            "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"span_id": s.span_id, "parent_id": s.parent_id, "request_id": s.request_id},
        })
    doc.setdefault("traceEvents", []).extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
