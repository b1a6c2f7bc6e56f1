"""Perceptual metrics: Butteraugli-style distance and SSIMULACRA2 score
(port of `jxl_tpu/metrics/perceptual.py`).

- `calculate_ssimulacra2`: positive-XYB colour, 6 dyadic scales (2x2 box
  downsampling), per scale x channel the (1 - SSIM), artifact and
  detail-loss maps, each pooled by a 1-norm and a 4-norm, weighted by the
  reference's separable factors.
- `calculate_butteraugli`: XYB opsin input with a B-Y residual, a 5-band
  decomposition (UHF/HF/MF/LF/LF2), activity masking from the original's
  high-frequency energy, the added-energy asymmetry and the response
  nonlinearity; returns (max distance, 3-norm).

The weight constants are copies of the reference's, held equal by
`tests/test_torch_port_hygiene.py`. Images are `[..., H, W, 3]` u8; the
feature and map functions take one original against a batch of
distortions (`[1 or N, H, W, 3]` against `[N, H, W, 3]`) and run the
original and the batch through each blur in one call.
"""

from __future__ import annotations

import numpy as np
import torch

from jxl_tpu_torch.core.xyb import _BIAS, _CBRT_BIAS, _OPSIN_COEF, _mix3, srgb_to_linear
from jxl_tpu_torch.metrics.quality import _batched, _filter2d_sep, _gaussian_kernel, filtered_moments, image_pair


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over the H and W axes of [..., H, W, C]
    (radius int(3 sigma), symmetric padding, float32 taps)."""
    return _filter2d_sep(img, _gaussian_kernel(max(1, int(3 * sigma)), sigma))


def _xyb(u8: torch.Tensor) -> torch.Tensor:
    """XYB float32 [..., 3] of u8 sRGB pixels [..., 3], the same bits on
    the card and on the CPU: the sRGB curve is a 256-entry table computed on
    the CPU (`core.xyb.srgb_to_linear` of v / 255 in float32), the cube root
    is taken in float64 and rounded, and the rest is elementwise float32.

    The perceptual scores sum |1 - SSIM| over flat regions where that term
    is float32 rounding noise of a single repeated value: one ulp of
    difference in a transcendental function (the card's powf against the
    CPU's) moves a high-quality SSIMULACRA2 score by tenths of a point."""
    lut = srgb_to_linear(torch.arange(256, dtype=torch.float32) / 255.0).to(u8.device)
    lms = _mix3(_OPSIN_COEF, lut[u8.long()]) + _BIAS
    lms_g = (torch.clamp(lms, min=0.0).to(torch.float64) ** (1.0 / 3.0)).to(torch.float32) - _CBRT_BIAS
    l_, m_, s_ = lms_g[..., 0], lms_g[..., 1], lms_g[..., 2]
    return torch.stack([0.5 * (l_ - m_), 0.5 * (l_ + m_), s_], dim=-1)


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """x[..., 0] + x[..., 1] + x[..., 2], in that order on every device."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 box mean over the H and W axes of [..., H, W, C]; odd tails are
    edge-padded (unlike `quality._downsample2x`, which drops them). The
    four samples are summed in a fixed order."""
    *lead, h, w, c = img.shape
    x = img.reshape(-1, h, w, c)
    if h % 2:
        x = torch.cat([x, x[:, -1:]], dim=1)
    if w % 2:
        x = torch.cat([x, x[:, :, -1:]], dim=2)
    y = 0.25 * (x[:, 0::2, 0::2] + x[:, 1::2, 0::2] + x[:, 0::2, 1::2] + x[:, 1::2, 1::2])
    return y.reshape(*lead, *y.shape[1:])


# ---------------------------------------------------------------------------
# SSIMULACRA2
# ---------------------------------------------------------------------------

_S2_SCALES = 6
# separable weight factors (re-fitted stand-ins for the original's 108-dim
# trained vector; same feature family)
_S2_W_SCALE = np.asarray([0.25, 0.45, 0.85, 1.0, 0.75, 0.45], np.float32)
_S2_W_CH = np.asarray([12.0, 1.0, 0.6], np.float32)  # X errors most visible
# rows: (1-ssim, artifact, detail-loss), cols: (1-norm, 4-norm)
_S2_W_COMP = np.asarray([[1.0, 0.45], [1.7, 0.85], [1.1, 0.45]], np.float32)
_S2_GAIN = 38.0
_S2_POW = 0.53


def _positive_xyb(xyb: torch.Tensor) -> torch.Tensor:
    """SSIMULACRA2's positive-definite XYB variant: B is coded relative to
    Y, channels shifted/scaled away from zero so ratios are stable."""
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    return torch.stack([x * 14.0 + 0.42, y + 0.01, (b - y) + 0.55], dim=-1)


def _s2_weights(device) -> torch.Tensor:
    """[scales, 3 channels, 3 components, 2 norms] float32 feature weights."""
    w = (
        _S2_W_SCALE[:, None, None, None]
        * _S2_W_CH[None, :, None, None]
        * _S2_W_COMP[None, None, :, :]
    )
    return torch.from_numpy(w).to(device)


def _ssimulacra2_features(orig_u8: torch.Tensor, comp_u8: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] u8 pair (orig may be one image against a batch) ->
    features [..., scales, 3 channels, 3 components, 2 norms] float32."""

    def fn(o, c):
        a, b = _positive_xyb(_xyb(torch.cat([o, c]))).split([o.shape[0], c.shape[0]])
        c1, c2 = 0.0001, 0.0009
        feats = []
        for _s in range(_S2_SCALES):
            mu_a, mu_b, e_aa, e_bb, e_ab = filtered_moments(a, b, lambda x: _blur(x, 1.5))
            s11 = e_aa - mu_a * mu_a
            s22 = e_bb - mu_b * mu_b
            s12 = e_ab - mu_a * mu_b
            ssim = ((2 * mu_a * mu_b + c1) * (2 * s12 + c2)) / ((mu_a * mu_a + mu_b * mu_b + c1) * (s11 + s22 + c2))
            e_ssim = torch.abs(1.0 - ssim)  # [N, H, W, 3]

            # edge-ratio maps: what the distortion added vs removed
            ea = 1.0 + torch.abs(a - mu_a)
            eb = 1.0 + torch.abs(b - mu_b)
            d = eb / ea - 1.0
            artifact = torch.clamp(d, min=0.0)
            detail_loss = torch.clamp(-d, min=0.0)

            comps = []
            for m in (e_ssim, artifact, detail_loss):
                n1 = torch.mean(m, dim=(1, 2))  # [N, 3]
                n4 = torch.mean(m**4, dim=(1, 2)) ** 0.25
                comps.append(torch.stack([n1, n4], dim=-1))  # [N, 3, 2]
            feats.append(torch.stack(comps, dim=2))  # [N, 3, 3, 2]
            a = _downsample2(a)
            b = _downsample2(b)
        return torch.stack(feats, dim=1)  # [N, scales, 3, 3, 2]

    return _batched(fn, orig_u8, comp_u8)


def ssimulacra2_error(features: torch.Tensor) -> torch.Tensor:
    """Weighted feature error [..., scales, 3, 3, 2] -> [...] float32."""
    return torch.sum(features * _s2_weights(features.device), dim=(-4, -3, -2, -1))


def ssimulacra2_score(err: float) -> float:
    """Score from the weighted feature error, on the host: the deadzone
    absorbs float noise in the blur pyramid so identical images score
    exactly 100 (like the real tool)."""
    return 100.0 - _S2_GAIN * max(err - 2e-3, 0.0) ** _S2_POW


def calculate_ssimulacra2(orig, comp, *, device=None) -> float:
    """SSIMULACRA2 score: 100 = identical, lower = worse, negative = very
    bad (same orientation and anchors as the real tool)."""
    a, b = image_pair(orig, comp, device)
    return ssimulacra2_score(float(ssimulacra2_error(_ssimulacra2_features(a, b))))


# ---------------------------------------------------------------------------
# Butteraugli
# ---------------------------------------------------------------------------

# per-band (UHF, HF, MF, LF, LF2) x per-channel (X, Y, B-Y) visibility
# weights; the two coarse bands are weighted far above the texture bands
_BA_BAND_W = np.asarray(
    [
        [55.0, 7.0, 1.2],  # UHF
        [65.0, 9.0, 2.2],  # HF
        [270.0, 48.0, 15.0],  # MF
        [72.0, 16.0, 6.4],  # LF  (blur 5.4 - blur 16)
        [720.0, 160.0, 64.0],  # LF2 (blur 16: local mean / banding)
    ],
    np.float32,
)
_BA_ACT_W = np.asarray([30.0, 6.0, 2.0], np.float32)  # per-channel activity weights of the mask
_BA_ASYM = 1.2  # added energy counts this much more than removed
_BA_MASK = 14.0
_BA_GAIN = 8.0
# response nonlinearity: dist -> pivot * (dist / pivot)^gamma
_BA_RESP_GAMMA = 1.25
_BA_RESP_PIVOT = 1.8


def _butteraugli_map(orig_u8: torch.Tensor, comp_u8: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] u8 pair (orig may be one image against a batch) ->
    per-pixel distance [..., H, W] float32."""

    def fn(o, c):
        dev = c.device
        x = _xyb(torch.cat([o, c]))
        x = torch.cat([x[..., :2], (x[..., 2] - x[..., 1])[..., None]], dim=-1)  # B-Y chroma residual
        # the bands of the original and of every distortion, one blur call per sigma
        b0 = _blur(x, 0.6)
        b1 = _blur(x, 1.8)
        b2 = _blur(x, 5.4)
        b3 = _blur(x, 16.0)
        na = o.shape[0]
        bands = [t.split([na, c.shape[0]]) for t in (x - b0, b0 - b1, b1 - b2, b2 - b3, b3)]  # UHF..LF2
        ba = [t[0] for t in bands]
        bb = [t[1] for t in bands]

        # masking: local high-frequency activity of the ORIGINAL hides errors
        act = _blur(torch.abs(ba[0]) + torch.abs(ba[1]), 2.5)
        mask = 1.0 + _BA_MASK * _channel_sum(act * torch.from_numpy(_BA_ACT_W).to(dev))[..., None]

        # masking attenuates high-frequency error visibility only
        one = torch.ones_like(mask)
        band_masks = (mask, mask, torch.sqrt(mask), one, one)
        band_w = torch.from_numpy(_BA_BAND_W).to(dev)
        dist2 = torch.zeros(bb[0].shape[:-1], dtype=torch.float32, device=dev)
        for i in range(5):
            d = bb[i] - ba[i]
            # asymmetry: energy ADDED on top of the original band is more visible
            added = torch.abs(bb[i]) - torch.abs(ba[i])
            d = d * torch.where(added > 0, _BA_ASYM, 1.0)
            wd = d * band_w[i]
            dist2 = dist2 + _channel_sum((wd / band_masks[i]) ** 2)
        dist = _BA_GAIN * torch.sqrt(dist2)
        return _BA_RESP_PIVOT * (dist / _BA_RESP_PIVOT) ** _BA_RESP_GAMMA

    return _batched(fn, orig_u8, comp_u8)


def butteraugli_norms(dist: torch.Tensor):
    """(max, 3-norm) over the H and W axes of [..., H, W] distance maps."""
    return torch.amax(dist, dim=(-2, -1)), torch.mean(dist**3, dim=(-2, -1)) ** (1.0 / 3.0)


def calculate_butteraugli(orig, comp, *, device=None) -> tuple[float, float]:
    """Returns (max-distance, 3-norm) like the reference parses from
    `butteraugli_main` output."""
    a, b = image_pair(orig, comp, device)
    d_max, pnorm3 = butteraugli_norms(_butteraugli_map(a, b))
    return float(d_max), float(pnorm3)
