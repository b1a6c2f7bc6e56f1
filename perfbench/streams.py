"""The rANS stream shape of a container, read with the frozen container
reader: what the yardstick's byte formulas take."""

from __future__ import annotations

from perfbench.reference.container import read_container
from perfbench.reference.layout import lossless_layout, padded_layout


def shape(data: bytes) -> tuple:
    """(T steps, lanes, words, mantissa bytes) of a container's stream."""
    s = read_container(data)
    h = s.header
    lay = (lossless_layout if h.lossless else padded_layout)(h.height, h.width, h.lanes)
    return lay["T"], h.lanes, int(s.wcounts.sum()), int(s.mcounts.sum())
