"""The one traffic generator: a mix's data file says which loop runs and how.

A traffic mix is `perfbench/traffic/<mix>.json`. Its `loop` names a closed
loop, the module `perfbench/loops/<loop>.py`, whose class `Loop` the
harness builds and `run_window` drives; every other key of the mix is a
parameter of that loop. A loop takes its images and codec settings from the
configuration. Every loop is closed: one caller, whose next request waits
for the previous one's answer.

A loop has
- `Loop(cfg, mix, images, dev)`;
- `warm()`: every shape the window will use, once (set-up);
- `step(win, sample)`: one request (or one row of requests) of the window:
  it counts what it attempts and completes in `win` and offers each judged
  answer, a `Request`, to `sample`;
- optionally `count_host_syncs(counter)`: `counter(fn)` over one request.

The program's entry points are looked up on their modules at each call, so a
test can put a broken one in their place.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench import spans


@dataclass
class Request:
    """What one request of the window produced, kept for the judge."""

    image: int
    distance: float
    effort: int
    strategy: str  # the name of the AC-strategy variant it was coded under
    container: bytes
    pixels: torch.Tensor
    battery: dict | None = None


@dataclass
class Window:
    """What the measured window saw."""

    seconds: float = 0.0
    units: int = 0  # points (sweep) or round trips
    megapixels: float = 0.0
    attempted: int = 0
    failed: int = 0
    encode_ms: list = field(default_factory=list)
    containers: list = field(default_factory=list)  # every container of the window, in order


def codec():
    """The program's modules a loop calls into."""
    from jxl_tpu_torch.codec import config, decode, encode
    from jxl_tpu_torch.metrics import battery

    return config, encode, decode, battery


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Reservoir:
    """A uniform sample of at most k items of a stream, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.n = 0
        self.items = []

    def offer(self, make):
        """Count one item; keep make() if the draw takes it."""
        if self.n < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.items[j] = make()
        self.n += 1


def run_window(loop, seconds: float, sample: Reservoir) -> Window:
    """Drive `loop` until `seconds` have passed; the window closes when the
    request in flight at that moment has its answer, and its length is from
    the first request's start to that answer. A request that raises counts
    as failed."""
    win = Window()
    t0 = time.perf_counter()
    with spans.span("window"):
        while time.perf_counter() - t0 < seconds:
            attempted, units = win.attempted, win.units
            try:
                loop.step(win, sample)
            except Exception as exc:  # a failed request: counted, the loop goes on
                win.failed += (win.attempted - attempted) - (win.units - units)
                print(f"[perfbench] request failed: {exc!r}", file=sys.stderr, flush=True)
    win.seconds = time.perf_counter() - t0
    return win
