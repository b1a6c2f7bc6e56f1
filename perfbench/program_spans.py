"""The program's own stage spans in a traced run, and what they say.

While the profiler records the window, the program records its stage spans
(`jxl_tpu_torch/utils/trace.py`: `encode`, `encode.front_end`, ...,
`decode.reconstruct`), each with its parent, on the clock of the device
trace. A stage's **self time** is its spans' time less the part that their
child spans cover: the time the stage spends in its own code.

- `spans(trace)`: the program's spans inside the window, or None where the
  program has no tracer or its buffer dropped a span;
- `self_ms_per_unit(trace, name)`: a stage's self time per unit of work,
  what the per-layer readers `*.enc.*_ms` and `*.dec.*_ms` report;
- `stage_table(trace)`: per stage and unit, its self ms, the device's idle
  ms inside that self time, and the kernels and host-device copies that
  start inside it;
- `encode_coverage(trace)`: how much of the benchmark's `encode` spans, and
  of the device's idle time inside them, the program's encoder spans hold.
"""

from __future__ import annotations

import bisect

from perfbench import yardstick

ENCODER_ROOTS = ("encode", "encode.finalize")
ENCODER_STAGES = ("encode.front_end", "encode.acs", "encode.decide", "encode.epf", "encode.entropy",
                  "encode.screen", "encode.finalize")


def spans(trace):
    """The program's spans that lie inside the window, or None."""
    try:
        from jxl_tpu_torch.utils import trace as tracer
    except ImportError:
        return None
    if tracer.dropped():
        return None
    return tracer.spans_between(*trace.window)


def _minus(a: list, b: list) -> list:
    """The sorted disjoint intervals `a` less the sorted disjoint `b`."""
    out, j = [], 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if e > cur:
            out.append((cur, e))
    return out


def self_intervals(program_spans) -> dict:
    """{name: sorted disjoint (start, end) intervals}: each span's interval
    less those of its child spans."""
    children = {}
    for s in program_spans:
        if s.parent_id is not None:
            children.setdefault(s.parent_id, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in program_spans:
        own = _minus([(s.start_ns, s.end_ns)], yardstick.merged(children.get(s.span_id, [])))
        out.setdefault(s.name, []).extend(own)
    return {name: yardstick.merged(parts) for name, parts in out.items()}


def self_ms_per_unit(trace, name: str):
    """Milliseconds of the stage `name`'s self time per unit of the window's
    work, or None where there is no unit, no such span or no program span."""
    units = trace.counters.get("units")
    found = spans(trace) if units else None
    if not found:
        return None
    parts = self_intervals(found).get(name)
    if parts is None:
        return None
    return sum(e - s for s, e in parts) / 1e6 / units


def _overlap_ns(a: list, b: list) -> int:
    """Nanoseconds shared by two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _starts_in(parts: list, starts: list) -> int:
    """How many of the sorted `starts` fall inside the disjoint `parts`."""
    return sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s) for s, e in parts)


def stage_table(trace):
    """{stage: {spans, self_ms, idle_ms, kernels, dtoh, htod}} per unit of
    the window's work: spans of the stage, its self time, the part of it in
    which no kernel ran, and the kernels and `Memcpy DtoH` / `Memcpy HtoD`
    copies (its host syncs and uploads) that started inside it. None where
    the run has no unit or no program span."""
    units = trace.counters.get("units")
    found = spans(trace) if units else None
    if not found:
        return None
    kernels = trace.kernels()
    busy = yardstick.merged([(s, e) for _n, s, e in kernels])
    kernel_starts = sorted(s for _n, s, _e in kernels)
    copies = {kind: sorted(s for n, s, _e in trace.device_ops if n.startswith(f"Memcpy {kind}"))
              for kind in ("DtoH", "HtoD")}
    counts = {}
    for s in found:
        counts[s.name] = counts.get(s.name, 0) + 1
    table = {}
    for name, parts in sorted(self_intervals(found).items()):
        self_ns = sum(e - s for s, e in parts)
        table[name] = {
            "spans": counts[name] / units,
            "self_ms": self_ns / 1e6 / units,
            "idle_ms": (self_ns - _overlap_ns(parts, busy)) / 1e6 / units,
            "kernels": _starts_in(parts, kernel_starts) / units,
            "dtoh": _starts_in(parts, copies["DtoH"]) / units,
            "htod": _starts_in(parts, copies["HtoD"]) / units,
        }
    return table


def encode_coverage(trace):
    """(share of the benchmark's `encode` span time that the root `encode`
    and the encoder stages' self times account for, share of the device's
    idle time inside the benchmark's `encode` spans that lies inside the
    program's encoder spans), or None where there is nothing to compare."""
    found = spans(trace)
    outside = yardstick.merged([(s, e) for n, s, e in trace.spans if n == "encode"])
    if not found or not outside:
        return None
    mine = self_intervals(found)
    accounted = sum(e - s for name in ("encode",) + ENCODER_STAGES for s, e in mine.get(name, []))
    idle = _minus(outside, yardstick.merged([(s, e) for _n, s, e in trace.kernels()]))
    roots = yardstick.merged([(s.start_ns, s.end_ns) for s in found if s.name in ENCODER_ROOTS])
    idle_ns = sum(e - s for s, e in idle)
    return (accounted / sum(e - s for s, e in outside),
            _overlap_ns(idle, roots) / idle_ns if idle_ns else None)
