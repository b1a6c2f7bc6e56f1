"""The measurement tools of the port: counterparts of the repository's
`tools/*.py` scripts, which reach `jxl_tpu` and so cannot run where JAX is
absent.

Each `tools/X.py` is `jxl_tpu_torch/tools/X.py`, run as
`python -m jxl_tpu_torch.tools.X`, with the reference's CLI arguments,
environment knobs (`RD_EFFORT`, `RD_DISTANCES`, `RD_CORPUS`, `PROF_EFFORT`,
the codec's `JXL_TPU_*`) and printed table or JSON line, plus:

- `--device` (default `cuda:0`), resolved by `core.device.resolve_device`:
  a CUDA device without a card raises before any work, and nothing falls
  back to the CPU;
- output files under `benchmarks/tools/<tool>/` (git-ignored) unless
  `--out` says otherwise; no tool writes into `docs/`;
- stage times (`stage_time`): the median of warm host-clock runs, each
  ending in `torch.cuda.synchronize()`, and on CUDA the busy ms and the
  kernel count of one traced run (`bench.headline.traced`).

The numpy helpers shared with the reference (`make_test_images`'
generators, `rd_position_corpus.FAMILY`, `rd_bound`'s bound maths) are
copies, held equal to the originals by tests/test_torch_tools.py. Nothing
here imports torch at module level: `profile_startup` times that import.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
OUT_ROOT = REPO / "benchmarks" / "tools"
CORPUS_DIR = REPO / "test_images" / "synth"


def default_out(tool: str, filename: str) -> str:
    """`benchmarks/tools/<tool>/<filename>` under the repository root."""
    return str(OUT_ROOT / tool / filename)


def write_text(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path}")


def parser(doc: str | None) -> argparse.ArgumentParser:
    """An argument parser with the tools' `--device` option."""
    ap = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0", help="torch device (default cuda:0; cpu for the plain path)")
    return ap


def parse(ap: argparse.ArgumentParser, argv=None):
    """Parse argv and resolve `--device` (raises on CUDA without a card);
    the torch.device is `args.dev`."""
    from jxl_tpu_torch.core.device import resolve_device

    args = ap.parse_args(argv)
    args.dev = resolve_device(args.device)
    return args


def read_corpus(names) -> dict:
    """{name: RGB u8} of test_images/synth/<name>.png for each name."""
    from jxl_tpu_torch.core.io import read_image

    return {name: read_image(str(CORPUS_DIR / f"{name}.png")) for name in names}


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    import torch

    from jxl_tpu_torch.bench.headline import smi_line

    dev = torch.device(dev)
    return smi_line(dev) if dev.type == "cuda" else "cpu"


def stage_time(fn, dev, reps: int = 5) -> dict:
    """One warm-up call of fn, then `reps` timed calls on the host clock,
    each ending in a synchronise: {"ms": median, "min_ms", "busy_ms",
    "kernels", "out": the warm-up's result}. On CUDA busy_ms and kernels
    are those of one more, traced, call (`headline.traced`); else None."""
    import torch

    dev = torch.device(dev)
    out = fn()
    ts = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    busy = kernels = None
    if dev.type == "cuda":
        from jxl_tpu_torch.bench.headline import traced

        _, tr = traced(fn, dev, 1)
        busy, kernels = tr["busy_ms"], tr["kernels"]
    return {"ms": float(np.median(ts)), "min_ms": min(ts), "busy_ms": busy, "kernels": kernels, "out": out}


def stage_row(label: str, t: dict, note: str = "") -> str:
    """One printed row of a stage table: label, median ms, busy ms, kernels."""
    busy = "-" if t["busy_ms"] is None else f"{t['busy_ms']:.2f}"
    kern = "-" if t["kernels"] is None else str(t["kernels"])
    return f"{label:<40} {t['ms']:9.2f} ms  busy {busy:>8} ms  kernels {kern:>6}{'   ' + note if note else ''}"
