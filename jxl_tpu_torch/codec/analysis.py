"""Stable analysis entry point for measurement tools (port of
`jxl_tpu/codec/analysis.py`).

Tools that study the encoder's token stream (bit breakdowns, context and
nnz studies, stage profiles) need stage 1 of the encode without the
entropy and packing tail. They call this function, whose signature stays
put, instead of reaching into `codec.encode`.
"""

from __future__ import annotations

import numpy as np
import torch

from jxl_tpu_torch.codec.encode import tokens_from_rgb
from jxl_tpu_torch.core.device import resolve_device


def encode_tokens_for_analysis(
    rgb, distance: float, *, height: int, width: int, effort: int = 7, hook_a: int = 0, hook_b: bool = False, device,
):
    """Stage 1 of the encode: pixels (RGB u8 [H, W, 3], numpy array or
    tensor) -> (token, nbits, mantissa [n_tokens] int32 tensors, params
    int, q_sorted [3, nb]) on `device`, the reference's five values in its
    order (`tokens_from_rgb` without its sixth, the value stream)."""
    dev = resolve_device(device)
    if not isinstance(rgb, torch.Tensor):
        rgb = torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.uint8))
    token, nbits, mant, params, q_sorted, _values = tokens_from_rgb(
        rgb.to(dev), distance, height=height, width=width, effort=effort, hook_a=hook_a, hook_b=hook_b
    )
    return token, nbits, mant, params, q_sorted
