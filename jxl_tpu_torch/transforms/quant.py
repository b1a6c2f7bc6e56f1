"""Quantisation tables and distance scaling (port of
`jxl_tpu/transforms/quant.py`).

step[c, u, v] = chan_base[c] * distance_scale(d) * freq_weight(u, v): a
pure function of (distance, channel, frequency), recomputed identically by
encoder and decoder — nothing is stored in the bitstream. The step tables
are float32, computed in the reference's order.

The JXL_TPU_CHAN_BASE / DC_BASE / FREQ_STRENGTH / RECON_BIAS overrides are
read under the reference's names (paired encode+decode tuning knobs, not
signalled in the container); production streams use the defaults.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch


def _env_floats(name: str, default):
    v = os.environ.get(name)
    if not v:
        return np.asarray(default, dtype=np.float32)
    return np.asarray([float(s) for s in v.split(",")], dtype=np.float32)


CHAN_BASE = _env_floats("JXL_TPU_CHAN_BASE", [0.0131, 0.0158, 0.0281])
DC_CHAN_BASE = _env_floats("JXL_TPU_DC_BASE", [0.0036, 0.0036, 0.0064])
FREQ_STRENGTH = float(os.environ.get("JXL_TPU_FREQ_STRENGTH", "0.8"))


@lru_cache(maxsize=None)
def _freq_weight_np(n: int, m: int) -> np.ndarray:
    u = np.arange(n)[:, None] / n
    v = np.arange(m)[None, :] / m
    radial = np.sqrt(u * u + v * v) / np.sqrt(2.0)  # 0 at DC, 1 at Nyquist corner
    return (1.0 + FREQ_STRENGTH * radial**1.5).astype(np.float32)


def _d32(distance, device) -> torch.Tensor:
    return torch.clamp(torch.tensor(float(distance), dtype=torch.float32, device=device), min=1e-4)


def distance_scale_t(distance, device) -> torch.Tensor:
    """d for d <= 1, d^1.1 above (float32 scalar tensor)."""
    d = _d32(distance, device)
    return torch.where(d <= 1.0, d, d**1.1)


def ac_steps_t(distance, n: int = 8, m: int = 8, *, device) -> torch.Tensor:
    """[3, n, m] float32 AC steps."""
    w = torch.from_numpy(_freq_weight_np(n, m)).to(device)[None, :, :]
    base = torch.from_numpy(CHAN_BASE).to(device)[:, None, None]
    return base * distance_scale_t(distance, device) * w


def dc_steps_t(distance, *, device) -> torch.Tensor:
    """[3] float32 DC steps (gentler distance response, d^0.8)."""
    return torch.from_numpy(DC_CHAN_BASE).to(device) * _d32(distance, device) ** 0.8


def ac_recon_bias() -> float:
    """AC reconstruction bias b: decoded coefficient = (q - b*sign(q)) * step.
    JXL_TPU_RECON_BIAS overrides."""
    return float(os.environ.get("JXL_TPU_RECON_BIAS", "0.10"))


def dequant_ac_biased(q: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Biased AC dequantisation (encoder-side mirror of the decoder's)."""
    qf = q.to(torch.float32)
    return (qf - ac_recon_bias() * torch.sign(qf)) * steps
