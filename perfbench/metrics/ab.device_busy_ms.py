"""`sweep.device_busy_ms` in the A/B cell: milliseconds of the window in which a kernel
ran (the union of the kernel intervals), per point."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "sweep.device_busy_ms")
