"""Adaptive quantisation field — per-block masking-based step multipliers
(port of `jxl_tpu/transforms/adaptive.py`).

Local activity of the XYB luma plane drives a per-block multiplier, snapped
to 16 exponential levels and signalled one token per 8x8 block, so the
decoder reproduces the exact step field.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

QF_LEVELS = 16
QF_TABLE = np.exp(np.linspace(np.log(0.55), np.log(2.6), QF_LEVELS)).astype(np.float32)
QF_CENTER_IDX = int(np.argmin(np.abs(QF_TABLE - 1.0)))

_ACT_REF = 0.02
_STRENGTH = 0.55


def quant_field(y_plane: torch.Tensor) -> torch.Tensor:
    """[Hp, Wp] luma -> per-block multiplier indices [nby, nbx] int64."""
    h, w = y_plane.shape
    yp = F.pad(y_plane[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    c = yp[1:-1, 1:-1]
    lap = torch.abs(4.0 * c - yp[:-2, 1:-1] - yp[2:, 1:-1] - yp[1:-1, :-2] - yp[1:-1, 2:])
    act = lap.reshape(h // 8, 8, w // 8, 8).mean(dim=(1, 3))
    mul = torch.exp2(_STRENGTH * torch.log2(1.0 + act / _ACT_REF) - _STRENGTH * 1.0)
    table = torch.from_numpy(QF_TABLE).to(y_plane.device)
    return torch.argmin(torch.abs(torch.log(mul)[..., None] - torch.log(table)), dim=-1)


def qf_multiplier(idx: torch.Tensor) -> torch.Tensor:
    """Indices -> multipliers (both sides of the codec use this table)."""
    return torch.from_numpy(QF_TABLE).to(idx.device)[idx.to(torch.int64)]
