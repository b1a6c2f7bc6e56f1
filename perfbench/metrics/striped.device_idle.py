"""`codec.device_idle` in the striped cell: per cent of the window in which no kernel
ran on the device."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "codec.device_idle")
