"""XYB opsin colour transform (port of `jxl_tpu/core/xyb.py`).

sRGB -> linear RGB -> LMS-like opsin mixing (+bias, cube root) -> XYB, and
back. The 3x3 channel mixes are written as elementwise multiply-adds in
float32, in the reference's order (no matmul, hence no TF32 question).
Constants are the public JPEG XL opsin-absorbance values.
"""

from __future__ import annotations

import numpy as _np
import torch

OPSIN_MATRIX = _np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.55180986650955360],
    ],
    dtype=_np.float32,
)

OPSIN_BIAS = _np.float32(0.0037930732552754493)
CBRT_OPSIN_BIAS = _np.cbrt(OPSIN_BIAS)

_OPSIN_NP = _np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.55180986650955360],
    ],
    dtype=_np.float64,
)
_OPSIN_INV_NP = _np.linalg.inv(_OPSIN_NP)

OPSIN_MATRIX_INV = _np.asarray(_OPSIN_INV_NP, dtype=_np.float32)

# float32-rounded coefficients: the reference multiplies float32 planes by
# these as weakly typed scalars, i.e. by their float32 values
_OPSIN_COEF = [[float(_np.float32(_OPSIN_NP[i, j])) for j in range(3)] for i in range(3)]
_OPSIN_INV_COEF = [[float(_np.float32(_OPSIN_INV_NP[i, j])) for j in range(3)] for i in range(3)]
_BIAS = float(OPSIN_BIAS)
_CBRT_BIAS = float(CBRT_OPSIN_BIAS)


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB electro-optical transfer function, input/output in [0, 1]."""
    srgb = srgb.to(torch.float32)
    return torch.where(srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(lin: torch.Tensor) -> torch.Tensor:
    lin = lin.to(torch.float32)
    return torch.where(
        lin <= 0.0031308,
        lin * 12.92,
        1.055 * torch.clamp(lin, min=1e-12) ** (1.0 / 2.4) - 0.055,
    )


def _mix3(m, v: torch.Tensor) -> torch.Tensor:
    """3x3 channel mix as elementwise float32 multiply-adds."""
    c0, c1, c2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            m[0][0] * c0 + m[0][1] * c1 + m[0][2] * c2,
            m[1][0] * c0 + m[1][1] * c1 + m[1][2] * c2,
            m[2][0] * c0 + m[2][1] * c1 + m[2][2] * c2,
        ],
        dim=-1,
    )


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of x >= 0 (torch has no cbrt): pow, then one Newton step
    in float32 to bring it to cbrt's accuracy."""
    y = x ** (1.0 / 3.0)
    return torch.where(y > 0, y - (y * y * y - x) / (3.0 * y * y), y)


def linear_rgb_to_xyb(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB [..., 3] -> XYB [..., 3]."""
    lms = _mix3(_OPSIN_COEF, rgb.to(torch.float32)) + _BIAS
    lms_g = _cbrt(torch.clamp(lms, min=0.0)) - _CBRT_BIAS
    l_, m_, s_ = lms_g[..., 0], lms_g[..., 1], lms_g[..., 2]
    return torch.stack([0.5 * (l_ - m_), 0.5 * (l_ + m_), s_], dim=-1)


def xyb_to_linear_rgb(xyb: torch.Tensor) -> torch.Tensor:
    """XYB [..., 3] -> linear RGB [..., 3]."""
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    lms_g = torch.stack([y + x, y - x, b], dim=-1)
    t = lms_g + _CBRT_BIAS
    lms = t * t * t - _BIAS
    return _mix3(_OPSIN_INV_COEF, lms)


def srgb_to_xyb(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB [..., 3] in [0,1] -> XYB [..., 3]."""
    return linear_rgb_to_xyb(srgb_to_linear(srgb))


def xyb_to_srgb(xyb: torch.Tensor) -> torch.Tensor:
    """XYB [..., 3] -> sRGB [..., 3], clipped to [0,1]."""
    return torch.clamp(linear_to_srgb(xyb_to_linear_rgb(xyb)), 0.0, 1.0)
