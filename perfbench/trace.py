"""The traced run: what `torch.profiler` saw of the device, beside the spans.

`Trace` holds, on one time line (nanoseconds of `time.time_ns()`):

- `spans`: (name, start, end) of the benchmark's spans (`spans.py`); the
  span named "window" is the measured window;
- `device_ops`: (name, start, end) of every device operation the profiler
  recorded in the window: kernels, and memory copies and sets;
- `counters`: counts taken in the traced run (`host_syncs` of one encode,
  the window's `units`, `megapixels`, `round_trips`);
- `containers`: every container the window produced, for readers that need
  the stream shapes.

A per-layer metric is a module `perfbench/metrics/<name>.py` whose
`read(trace)` returns the metric's value, or None where this trace holds
nothing for it.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from perfbench import yardstick

BREAKDOWN_ENTRIES = 10


@dataclass
class Trace:
    spans: list
    device_ops: list
    counters: dict = field(default_factory=dict)
    containers: list = field(default_factory=list)

    @property
    def window(self) -> tuple:
        """(start, end) of the measured window."""
        for name, s, e in self.spans:
            if name == "window":
                return s, e
        raise ValueError("the trace has no window span")

    @property
    def window_ns(self) -> int:
        s, e = self.window
        return e - s

    def kernels(self, name_part: str | None = None) -> list:
        """(name, start, end) of the window's kernels, those whose name holds
        `name_part` if given."""
        return [
            k for k in self.device_ops
            if yardstick.is_kernel(k[0]) and (name_part is None or name_part in k[0])
        ]

    def busy_ns(self) -> int:
        """Nanoseconds of the window in which a kernel ran (their union)."""
        return yardstick.union_ns([(s, e) for _n, s, e in self.kernels()])

    def span_ns(self, name: str) -> int:
        """Total nanoseconds of the spans named `name`."""
        return sum(e - s for n, s, e in self.spans if n == name)

    def span_count(self, name: str) -> int:
        """How many spans are named `name`."""
        return sum(1 for n, _s, _e in self.spans if n == name)

    def busy_in_ns(self, name: str) -> int:
        """Nanoseconds inside the spans named `name` in which a kernel ran."""
        busy = yardstick.merged([(s, e) for _n, s, e in self.kernels()])
        starts = [s for s, _e in busy]
        total = 0
        for n, s, e in self.spans:
            if n != name:
                continue
            k = max(bisect.bisect_right(starts, s) - 1, 0)
            while k < len(busy) and busy[k][0] < e:
                total += max(0, min(e, busy[k][1]) - max(s, busy[k][0]))
                k += 1
        return total

    def kernels_in(self, name: str) -> int:
        """Kernels that started inside a span named `name`."""
        ranges = sorted((s, e) for n, s, e in self.spans if n == name)
        starts = [s for s, _e in ranges]
        count = 0
        for _n, ks, _ke in self.kernels():
            k = bisect.bisect_right(starts, ks) - 1
            if k >= 0 and ks < ranges[k][1]:
                count += 1
        return count


def device_ops_of(events, window) -> list:
    """(name, start_ns, end_ns) of the profiler's device events inside
    `window`, clipped to it."""
    from torch.autograd import DeviceType

    ws, we = window
    out = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        s, t = max(e.start_ns(), ws), min(e.end_ns(), we)
        if t > s:
            out.append((e.name(), s, t))
    return out


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the window's idle
    time summed by the span that was open over it (the benchmark's spans
    do not nest inside the window)."""
    by_op = {}
    for n, s, e in tr.device_ops:
        by_op[n] = by_op.get(n, 0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]

    ws, we = tr.window
    busy = yardstick.merged([(s, e) for _n, s, e in tr.kernels()])
    gaps, cur = [], ws
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if we > cur:
        gaps.append((cur, we))
    gap_ends = [e for _s, e in gaps]
    by_span = {}
    covered = 0
    for n, s, e in tr.spans:
        if n == "window":
            continue
        k = bisect.bisect_left(gap_ends, s)
        while k < len(gaps) and gaps[k][0] < e:
            part = min(e, gaps[k][1]) - max(s, gaps[k][0])
            if part > 0:
                by_span[n] = by_span.get(n, 0) + part
                covered += part
            k += 1
    total = sum(e - s for s, e in gaps)
    if total > covered:
        by_span["(between spans)"] = total - covered
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {
        "device_ops": [[n, ns / 1e9] for n, ns in ops],
        "idle_gaps": [[n, ns / 1e9] for n, ns in idle],
    }
