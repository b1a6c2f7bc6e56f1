"""`sweep.battery_ms` in the A/B cell: milliseconds a point of the `battery` spans
(`metric_battery_grid_async` and its finalize) in the window."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "sweep.battery_ms")
