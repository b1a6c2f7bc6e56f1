#!/usr/bin/env python3
"""A traced run of one benchmark cell with the program's stage table:

    python3 probes/stage_table.py --workload <cell> --seed <n> --seconds <s> [--device cuda:0] [--out DIR]

Run from the repository root. It runs the cell as `perfbench/run.py
--trace 1` does (`harness.run_cell`, the same set-up, window and judge) and
prints that run's result line, then keeps the run's trace and prints, as
one JSON line tagged "stages":

- `table`: per stage of the program (`perfbench/program_spans.py:
  stage_table`), per unit of work, its spans, self ms, device-idle ms
  inside that self time, and the kernels and DtoH / HtoD copies that
  started inside it;
- `coverage`: the share of the benchmark's `encode` span time that the
  program's root `encode` and encoder stage self times account for, and
  the share of the device's idle time inside the benchmark's `encode`
  spans that lies inside the program's encoder spans;
- `spans_per_unit`, the outside `encode_ms` per unit, and the tracer's
  cost per span site on this host with tracing off and on (`tracer_us`);
- the card's name and power limit.

With --out DIR the two lines are also written to DIR/<cell>.<seed>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent


def tracer_cost_us(n: int = 200_000) -> dict:
    """Microseconds per `with span(...)` site, tracing off and under a
    Recorder, over n spans each."""
    from jxl_tpu_torch.utils import trace

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("probe"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    assert not trace.tracing()
    off = loop()
    with trace.Recorder(capacity=n):
        on = loop()
    return {"off": off, "on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness, program_spans
    from perfbench import run as perfbench_run
    from perfbench import trace as ptrace

    perfbench_run.environment()
    kept = []

    class KeptTrace(ptrace.Trace):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    ptrace.Trace = KeptTrace  # run_cell takes it from the module at each call
    cost = tracer_cost_us()
    cell = harness.resolve(ROOT, harness.load_manifest(ROOT), args.workload)
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=True, device=args.device,
                              t_start=T_START)
    print(json.dumps(result), flush=True)
    tr = kept[-1]
    units = tr.counters["units"]
    found = program_spans.spans(tr) or []
    stages = {
        "stages": args.workload, "seed": args.seed,
        "table": program_spans.stage_table(tr),
        "coverage": program_spans.encode_coverage(tr),
        "spans_per_unit": len(found) / units if units else None,
        "outside_encode_ms": tr.span_ns("encode") / 1e6 / units if units else None,
        "units": units,
        "tracer_us": cost,
        "card": result["device"]["kind"], "power_limit_w": result["device"]["power_limit_w"],
    }
    print(json.dumps(stages), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{args.workload}.{args.seed}.json"), "w") as f:
            f.write(json.dumps(result) + "\n" + json.dumps(stages) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
