"""One run of one cell: set-up, the measured window, the metrics, the judge.

Everything a cell needs is found by name from `BENCHMARK.json`:

- its configuration: the file that the manifest's `configs` entry names
  (`perfbench/configs/<config>.json`): the images (size, count, source),
  the codec settings, the sweep grid, its judge and the limits of the
  judge's numbers;
- its images: `perfbench/sources/<source>.py`, whose `images(spec, seed,
  device)` makes them from the configuration's `images` and the seed;
- its traffic mix: `perfbench/traffic/<traffic>.json`, read by `load.py`,
  which drives the loop it names, `perfbench/loops/<loop>.py`;
- its judge: `perfbench/reference/judges/<judge>.py`, the comparison that
  decides `correct` for the configuration's coding family;
- each end-to-end metric: `perfbench/end_to_end/<metric>.py`, whose
  `read(run)` takes the untraced run's `Run`;
- each per-layer metric: `perfbench/metrics/<metric>.py`, whose
  `read(trace)` takes the traced run's `trace.Trace`.

A cell reports the end-to-end metrics that list it under `workloads`, or
have no `workloads`, and the per-layer metrics of the same rule.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
import warnings
from dataclasses import dataclass
from pathlib import Path

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "jxl_tpu")
JUDGED = 12  # requests or points a run keeps for the judge, unless the config says "judged"


class CellError(ValueError):
    """The manifest or a file it names does not define the cell."""


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """A cell of the manifest, with everything its names resolve to."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    root: Path


def resolve(root: Path, manifest: dict, workload: str) -> Cell:
    cell = _named(manifest["workloads"], workload, "workload")
    cfg_entry = _named(manifest["configs"], cell["config"], "config")
    cfg_file = root / cfg_entry["file"]
    mix_file = root / "perfbench" / "traffic" / f"{cell['traffic']}.json"
    for f in (cfg_file, mix_file):
        if not f.is_file():
            raise CellError(f"{workload}: {f.relative_to(root)} is missing")
    config, mix = json.loads(cfg_file.read_text()), json.loads(mix_file.read_text())
    for kind, name in (("loops", mix["loop"]), ("sources", config["images"]["source"]),
                       ("reference/judges", config["judge"])):
        piece_file(root, kind, name)
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, workload) and m["moves"] in names]
    for m in e2e:
        piece_file(root, "end_to_end", m["name"])
    for m in per_layer:
        piece_file(root, "metrics", m["name"])
    return Cell(workload, int(cell["chips"]), config, mix, e2e, per_layer, root)


def piece_file(root: Path, kind: str, name: str) -> Path:
    """perfbench/<kind>/<name>.py, or a CellError that names it."""
    f = root / "perfbench" / kind / f"{name}.py"
    if not f.is_file():
        raise CellError(f"{name!r} has no module {f.relative_to(root)}")
    return f


def piece(root: Path, kind: str, name: str):
    """The module perfbench/<kind>/<name>.py."""
    f = piece_file(root, kind, name)
    modname = f"perfbench_piece.{kind.replace('/', '.')}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(modname, f)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod  # a dataclass looks its module up by name
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, kind: str, name: str):
    """The `read` function of perfbench/<kind>/<name>.py."""
    return piece(root, kind, name).read


def images_of(cell: Cell, seed: int, dev) -> list:
    """The cell's originals for `seed`, from its configuration's source."""
    spec = cell.config["images"]
    return piece(cell.root, "sources", spec["source"]).images(spec, seed, dev)


def make_loop(cell: Cell, images: list, dev):
    """The closed loop the cell's traffic mix names, over `images`."""
    return piece(cell.root, "loops", cell.mix["loop"]).Loop(cell.config, cell.mix, images, dev)


def judge_of(cell: Cell):
    """The module that judges the cell's configuration."""
    return piece(cell.root, "reference/judges", cell.config["judge"])


@dataclass
class Run:
    """What an end-to-end reader sees: the window and the set-up time."""

    window: object  # load.Window
    setup_s: float


def forbidden_loaded() -> list:
    """Top-level names in sys.modules that the benchmark must not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def count_host_syncs(fn) -> int:
    """Host synchronisations in fn(), as `torch.cuda.set_sync_debug_mode
    ("warn")` reports them."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def points_of(judge, items, images) -> list:
    """The judge's points of the sampled requests (`load.Request`)."""
    return [judge.Point(images[r.image], r.distance, r.effort, r.pixels, r.strategy, container=r.container,
                        battery=r.battery)
            for r in items]


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run the cell once on `device` and return the result line's dict."""
    import torch

    from perfbench import load, spans, yardstick
    from perfbench.trace import Trace, breakdown, device_ops_of

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = cell.config
    images = images_of(cell, seed, dev)
    loop = make_loop(cell, images, dev)
    loop.warm()
    if cuda:
        torch.cuda.synchronize(dev)
    sample = load.Reservoir(int(cfg.get("judged", JUDGED)), seed)
    setup_s = time.perf_counter() - t_start

    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with spans.Recorder() as rec, profile(activities=activities) as prof:
            win = load.run_window(loop, seconds, sample)
            if cuda:
                torch.cuda.synchronize(dev)
        window = next((s, e) for n, s, e in rec.spans if n == "window")
        ops = device_ops_of(prof.profiler.kineto_results.events(), window)
        counters = {"units": win.units, "megapixels": win.megapixels}
        if cuda and hasattr(loop, "count_host_syncs"):
            counters["host_syncs"] = loop.count_host_syncs(count_host_syncs)
        tr = Trace(rec.spans, ops, counters, win.containers)
    else:
        win = load.run_window(loop, seconds, sample)
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"modules loaded that the benchmark must not load: {found}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    metrics = {}
    if tr is None:
        run = Run(win, setup_s)
        for m in cell.end_to_end:
            v = reader(cell.root, "end_to_end", m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = reader(cell.root, "metrics", m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    card = yardstick.card_info(dev) if cuda else {"name": "cpu", "power_limit_w": None}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
        "power_limit_w": card["power_limit_w"],
    }
    result = {"correct": False, "attempted": win.attempted, "failed": win.failed, "metrics": metrics,
              "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_ns() / 1e9
        device_info["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = breakdown(tr)
        del tr

    # the judge runs after the window, the peak read and the window's own
    # outputs let go; only the sample and the originals stay
    del win, loop
    if cuda:
        torch.cuda.empty_cache()
    judge = judge_of(cell)
    t0 = time.perf_counter()
    numbers = judge.judge(points_of(judge, sample.items, images))
    limits = {k: float(v) for k, v in cfg["correct_limits"].items()}
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise CellError(f"config {cell.config['name']!r} gives no limit for {missing}")
    result["correct"] = result["failed"] == 0 and judge.verdict(numbers, limits)
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    print(f"[perfbench] judged {len(sample.items)} of {sample.n} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return result
