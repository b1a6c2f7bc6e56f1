"""`sweep.encode_ms` in the A/B cell: milliseconds a point of the `encode` spans
(`encode_image_grid` under the row's homogeneity strategy) in the window."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "sweep.encode_ms")
