"""`codec.device_busy_ms` in the striped cell: milliseconds of the window in which a
kernel ran (the union of the kernel intervals), per round trip."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "codec.device_busy_ms")
