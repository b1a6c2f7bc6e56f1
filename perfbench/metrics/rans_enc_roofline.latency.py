"""`rans_enc_roofline`, B3's share of its roofline, in the cells that report
`encode_p95_ms`: the same reading, moving that metric."""

from pathlib import Path

from perfbench.harness import reader

read = reader(Path(__file__).resolve().parents[2], "metrics", "rans_enc_roofline")
