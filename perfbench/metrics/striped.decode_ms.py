"""`codec.decode_ms` in the striped cell: milliseconds a round trip of the `decode`
spans (`decode_bytes_device` of the wrapper: every section, the stitch, and the
synchronise) in the window."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "codec.decode_ms")
