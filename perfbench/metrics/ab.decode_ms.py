"""`sweep.decode_ms` in the A/B cell: milliseconds a point of the `decode` spans
(`decode_bytes_grid_stacked` and its synchronise) in the window."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "sweep.decode_ms")
