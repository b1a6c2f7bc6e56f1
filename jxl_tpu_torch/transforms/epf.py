"""Edge-preserving filter (EPF) — decode-side deblocking/deringing (port of
`jxl_tpu/transforms/epf.py`).

One pass of a 4-neighbour cross kernel over the XYB planes; a neighbour's
weight falls with its difference relative to a per-pixel sigma derived
from the signalled quant field (coarser blocks -> stronger smoothing).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPF_BASE = (0.0035, 0.0045, 0.008)
_EPF_DISTANCE_POW = 0.8


def epf_sigma(eff_mul: torch.Tensor, distance, height: int, width: int) -> torch.Tensor:
    """Per-pixel sigma field from the per-block multipliers; the strength
    ramps to 0 as d -> 0.5 (see the reference module)."""
    d = torch.clamp(torch.tensor(float(distance), dtype=torch.float32, device=eff_mul.device), min=1e-4)
    ramp = torch.clamp(1.0 - torch.exp(-(d - 0.5) / 1.2), 0.0, 1.0)
    strength = d**_EPF_DISTANCE_POW * ramp
    sig_block = eff_mul * strength
    sig_pix = torch.repeat_interleave(torch.repeat_interleave(sig_block, 8, dim=0), 8, dim=1)
    return sig_pix[:height, :width]


def epf_filter_ext(planes_ext: torch.Tensor, sig_pix: torch.Tensor) -> torch.Tensor:
    """Core filter given 1-pixel halos: planes_ext [3, H+2, W+2] -> [3, H, W]."""
    h, w = planes_ext.shape[-2] - 2, planes_ext.shape[-1] - 2
    out = []
    for c in range(3):
        xp = planes_ext[c]
        x = xp[1 : 1 + h, 1 : 1 + w]
        sigma = sig_pix * _EPF_BASE[c]
        acc = x
        wacc = torch.ones_like(x)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nb = xp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            t = torch.abs(nb - x) / torch.clamp(sigma, min=1e-8)
            wgt = torch.clamp(1.0 - 0.5 * t * t, min=0.0)
            acc = acc + wgt * nb
            wacc = wacc + wgt
        out.append(acc / wacc)
    return torch.stack(out)


def epf_apply(planes: torch.Tensor, eff_mul: torch.Tensor, distance) -> torch.Tensor:
    """planes: [3, Hp, Wp] XYB (B as residual); eff_mul: [nby, nbx]
    per-block step multipliers. Returns filtered planes."""
    h, w = planes.shape[-2:]
    sig_pix = epf_sigma(eff_mul, distance, h, w)
    planes_ext = F.pad(planes[None], (1, 1, 1, 1), mode="replicate")[0]
    return epf_filter_ext(planes_ext, sig_pix)
