"""rANS constants and on-device histogram quantisation (port of
`jxl_tpu/entropy/rans.py`).

Scheme: 32-bit states, 16-bit renormalisation words, 12-bit frequency
precision. Single-conditional renorm is exact for these parameters
(2^32 >> 16 = 2^16 < f << 20 for all f >= 1).
"""

from __future__ import annotations

import torch

RANS_PRECISION = 12  # frequency bits; M = 4096
RANS_M = 1 << RANS_PRECISION
RANS_L = 1 << 16  # state lower bound


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along `dim`, in x's dtype."""
    return (torch.cumsum(x, dim=dim) - x).to(x.dtype)


def quantize_histograms_t(counts: torch.Tensor):
    """Per-context counts [C, A] -> (freq, cum) int32 tables summing to 2^12.

    Bit-exact twin of the reference's traced form: unused contexts put all
    mass on symbol 0; the ratio is taken in float32; every symbol with a
    nonzero count keeps freq >= 1; the argmax bucket absorbs the rounding
    remainder; single-symbol contexts are capped at M-1 so `f << 20` never
    overflows 32 bits in the encoder."""
    c = counts.to(torch.int32)
    a = c.shape[1]
    total = torch.sum(c, dim=1, keepdim=True).to(torch.int32)
    c = c.clone()
    c[:, 0] += (total[:, 0] == 0).to(torch.int32)
    total = torch.clamp(total, min=1)
    f = torch.floor((c.to(torch.float32) / total.to(torch.float32)) * RANS_M).to(torch.int32)
    f = torch.where((c > 0) & (f == 0), 1, f)
    diff = RANS_M - torch.sum(f, dim=1).to(torch.int32)
    am = torch.argmax(f, dim=1)
    col = torch.arange(a, device=c.device)[None, :]
    onehot_am = am[:, None] == col
    f = f + torch.where(onehot_am, diff[:, None], 0)
    over = (torch.amax(f, dim=1) >= RANS_M)[:, None]
    onehot_next = ((am + 1) % a)[:, None] == col
    f = f - (onehot_am & over).to(torch.int32) + (onehot_next & over).to(torch.int32)
    f = f.to(torch.int32)
    return f, exclusive_cumsum(f, dim=1)
