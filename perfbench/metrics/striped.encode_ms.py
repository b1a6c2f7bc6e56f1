"""`codec.encode_ms` in the striped cell: milliseconds a round trip of the `encode`
spans (`tiled.encode_image_striped`, every stripe) in the window."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "codec.encode_ms")
