"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix and
metrics are found by name from BENCHMARK.json. The run needs a CUDA card
and as many as the cell asks for; without them it exits non-zero and prints
no result. It makes its images from the seed on the card, warms up the
cell's shapes (set-up, `setup_s`), drives the cell's closed loop for the
given seconds, then judges a sample of what the window produced against the
frozen reference in `perfbench/reference/`. The last line of standard
output is one JSON object; the numbers the judge compared, each beside its
limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def environment():
    """The program's caches inside the checkout, at fixed paths, and none of
    its tuning knobs: the program runs as the configurations state."""
    for k in [k for k in os.environ if k.startswith("JXL_TPU")]:
        del os.environ[k]
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.resolve(ROOT, harness.load_manifest(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[perfbench] {args.workload} needs {cell.chips} CUDA card(s); found {n}", file=sys.stderr)
        return 1
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                              device="cuda:0", t_start=T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"[perfbench] loaded modules the benchmark must not load: {found}", file=sys.stderr)
        return 1
    for k, v in result["compared"].items():
        print(f"[perfbench] {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
