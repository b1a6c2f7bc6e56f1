"""Striped JXTS containers, frozen: copies of `jxl_tpu_torch/codec/tiled.py`'s
wrapper reader and its header check, the stripe widths, the majority vote on
EPF and the stitch of a run of VarDCT sections, over this package's frozen
reconstruction (`codec._reconstruct(..., epf=False, return_planes=True)`),
EPF (`epf.epf_apply`) and colour transform (`xyb.xyb_to_srgb`).

A `JXTS` wrapper holds N independent single-image containers, each a
full-height vertical stripe (widths multiples of 8 px, the last taking the
remainder). A run of consecutive VarDCT sections is decoded to pre-EPF XYB
planes, the planes are concatenated, and one EPF pass runs over the run when
the majority of its sections signal EPF, so the seam columns are filtered
with their true neighbours.
"""

from __future__ import annotations

import struct

import torch

from perfbench.reference.codec import _reconstruct
from perfbench.reference.container import MAX_DIM, _check
from perfbench.reference.epf import epf_apply
from perfbench.reference.xyb import xyb_to_srgb

STRIPED_MAGIC = b"JXTS"
STRIPED_VERSION = 1
_HEAD = "<4sBBHII"  # magic, version, flags, section count, height, width


def stripe_widths(width: int, n_stripes: int) -> list[int]:
    """Split `width` into n stripes, each a multiple of 8 px; the last
    absorbs the remainder."""
    _check(width >= 8 * n_stripes, f"width {width} too small for {n_stripes} stripes")
    base = (width // n_stripes) // 8 * 8
    widths = [base] * n_stripes
    widths[-1] = width - base * (n_stripes - 1)
    return widths


def read_striped_header(data: bytes):
    """-> (height, width, section count) of a wrapper, validated;
    ValueError on a malformed one."""
    _check(data[:4] == STRIPED_MAGIC, "bad magic (not a striped JXT stream)")
    try:
        _magic, version, _flags, n, height, width = struct.unpack_from(_HEAD, data, 0)
    except struct.error as e:
        raise ValueError(f"malformed striped container: truncated ({e})") from e
    _check(version == STRIPED_VERSION, f"unknown striped version {version}")
    _check(0 < height <= MAX_DIM and 0 < width <= MAX_DIM and n >= 1, "bad striped geometry")
    return height, width, n


def read_striped(data: bytes):
    """-> (height, width, [section bytes]); ValueError on any malformed
    wrapper: every declared length is checked against the buffer."""
    height, width, n = read_striped_header(data)
    try:
        off = struct.calcsize(_HEAD)
        _check(off + 4 * n <= len(data), "section table overruns buffer")
        lens = struct.unpack_from(f"<{n}I", data, off)
    except struct.error as e:
        raise ValueError(f"malformed striped container: truncated ({e})") from e
    off += 4 * n
    sections = []
    for L in lens:
        _check(off + L <= len(data), f"striped section needs bytes [{off}, {off + L}) of {len(data)}")
        sections.append(data[off : off + L])
        off += L
    _check(off == len(data), f"{len(data) - off} trailing bytes")
    return height, width, sections


def epf_vote(epf_bits) -> bool:
    """Whether a run of VarDCT sections gets its EPF pass: the majority of
    its sections signal EPF."""
    bits = list(epf_bits)
    return sum(1 for b in bits if b) * 2 > len(bits)


def section_planes(values: torch.Tensor, distance, dec_params: int, height: int, width: int):
    """A section's value stream -> (pre-EPF padded XYB planes [3, hp, wp]
    with B as Y-residual, eff_mul [nby, nbx])."""
    return _reconstruct(values, distance, dec_params, height=height, width=width, epf=False, return_planes=True)


def stitch(planes_parts, mul_parts, distance, *, height: int, width: int, epf: bool) -> torch.Tensor:
    """The sections' planes of one run, in order -> RGB u8 [height, width, 3]:
    the planes concatenated, one EPF pass over the run if `epf`, then the
    inverse colour transform (B is coded as a residual on Y)."""
    planes = torch.cat(list(planes_parts), dim=-1)
    if epf:
        planes = epf_apply(planes, torch.cat(list(mul_parts), dim=-1), distance)
    planes = planes[:, :height, :width]
    x, y, b_res = planes[0], planes[1], planes[2]
    srgb = xyb_to_srgb(torch.stack([x, y, b_res + y], dim=-1))
    return torch.round(srgb * 255.0).to(torch.uint8)
