"""Quality metrics in plain torch (port of `jxl_tpu/metrics/quality.py`).

MSE, PSNR, SSIM and MS-SSIM over RGB u8 pixel values (0..255), PSNR with
max = 255, `file_size_ratio` 0.0 on a zero denominator: the reference's
conventions. Every image function takes `[..., H, W, C]`: leading
dimensions are a batch (the sweep battery scores a whole RD row, `[N, H,
W, 3]`, at once); reductions run per image over H, W and C.

The separable filters are direct convolutions written out as float32
multiplies and adds over shifted views, tap by tap in a fixed order, over
symmetric padding (the edge sample repeated, as `np.pad(mode="symmetric")`).
Every step is one correctly rounded elementwise operation, so the card and
the CPU filter bit for bit alike, whatever algorithm a convolution library
would pick per device and shape. SSIM and SSIMULACRA2 take E[a^2] - E[a]^2
against small constants; on flat content the result is float32 rounding
noise, which |1 - SSIM| turns into a bias: a metric column is reproducible
across devices only if that noise is.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

# "fp32": the vertical pass, then the horizontal one, in float32 (what the
# battery is held to); "fp32_reordered": the horizontal pass first, a sound
# float32 variant that rounds differently; "bf16": every tap's product and
# sum in bfloat16, the step below float32 for elementwise arithmetic. Only
# the calibration of the judge's limits sets the last two.
_FILTER = {"mode": "fp32"}


@contextmanager
def filter_precision(name: str):
    """Run the separable filters inside in `name` ("fp32", "fp32_reordered"
    or "bf16")."""
    if name not in ("fp32", "fp32_reordered", "bf16"):
        raise ValueError(f"unknown filter precision {name!r}")
    old = _FILTER["mode"]
    _FILTER["mode"] = name
    try:
        yield
    finally:
        _FILTER["mode"] = old


def file_size_ratio(a: float, b: float) -> float:
    """Size ratio a/b with the reference's 0-denominator convention."""
    if b == 0:
        return 0.0
    return float(a) / float(b)


def image_pair(orig, comp, device=None):
    """(orig, comp) as tensors on one device: `device` if given, else the
    device of the tensors among them (numpy inputs need `device`)."""
    if device is None:
        devs = {x.device for x in (orig, comp) if isinstance(x, torch.Tensor)}
        if len(devs) != 1:
            raise ValueError("pass device= for numpy inputs, or two tensors on one device")
        device = devs.pop()
    dev = torch.device(device)
    return tuple((x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))).to(dev) for x in (orig, comp))


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image MSE of [..., H, W, C] pixel arrays (float32)."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.mean(d * d, dim=(-3, -2, -1))


def calculate_mse(orig, comp, *, device=None) -> float:
    """Mean squared error over u8 RGB pixels (all channels pooled)."""
    a, b = image_pair(orig, comp, device)
    return float(_mse(a, b))


def psnr_from_mse(mse: float, max_value: float = 255.0) -> float:
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(max_value * max_value / mse))


def calculate_psnr(orig, comp, max_value: float = 255.0, *, device=None) -> float:
    return psnr_from_mse(calculate_mse(orig, comp, device=device), max_value)


def _gaussian_kernel(radius: int = 5, sigma: float = 1.5) -> torch.Tensor:
    """Normalised Gaussian taps, built in float32 on the CPU as the
    reference builds them (callers move them to their device). The sum
    runs in tap order, as the reference's reduction of a short tap vector
    does: the taps' rounded sum sets the bias of every filtered variance
    (E[a^2] - E[a]^2 on flat content), which SSIM compares against c2."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / float(np.add.accumulate(k.numpy())[-1])  # a float32 running sum


def symmetric_index(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each sample of an axis of length n padded by `pad`
    on both sides in `np.pad(..., mode="symmetric")` order (the edge sample
    repeated), for any pad, also one larger than the axis."""
    i = torch.arange(-pad, n + pad, device=device)
    j = torch.remainder(i, 2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


def _filter2d_sep(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable 2D filter over the H and W axes of [..., H, W, C]:
    symmetric padding, the vertical pass, then the horizontal one, each a
    float32 sum over the taps in order (one rounded multiply and one rounded
    add per tap)."""
    *lead, h, w, c = img.shape
    x = img.reshape(-1, h, w, c)
    pad = kernel.shape[0] // 2
    taps = [float(t) for t in kernel]
    mode = _FILTER["mode"]
    if mode == "bf16":
        x = x.to(torch.bfloat16)
    for axis in ((2, 1) if mode == "fp32_reordered" else (1, 2)):
        n = x.shape[axis]
        x = x.index_select(axis, symmetric_index(n, pad, x.device))
        v = x.narrow(axis, 0, n) * taps[0]
        for i in range(1, len(taps)):
            v = v + x.narrow(axis, i, n) * taps[i]
        x = v
    return x.to(torch.float32).reshape(*lead, h, w, c)


def filtered_moments(a: torch.Tensor, b: torch.Tensor, filt):
    """filt of (a, b, a*a, b*b, a*b) for a [Na, H, W, C] and b [Nb, H, W, C]
    with Na in (1, Nb): one filter call over the concatenated batch, so a
    comparison of an image with itself filters bit-identical inputs in one
    launch and gets bit-identical moments."""
    ab = a * b
    parts = filt(torch.cat([a, b, a * a, b * b, ab]))
    return torch.split(parts, [a.shape[0], b.shape[0], a.shape[0], b.shape[0], ab.shape[0]])


def _batched(fn, a: torch.Tensor, b: torch.Tensor):
    """fn over [N, H, W, C] batches; an unbatched [H, W, C] pair goes in as a
    batch of one and comes back without the batch axis."""
    if a.dim() == 3 and b.dim() == 3:
        return fn(a[None], b[None])[0]
    return fn(a.reshape(-1, *a.shape[-3:]), b.reshape(-1, *b.shape[-3:]))


def _ssim_map(a: torch.Tensor, b: torch.Tensor, max_value: float = 255.0) -> torch.Tensor:
    """SSIM (Wang et al.) with an 11x11 Gaussian sigma=1.5 window, per
    channel: [..., H, W, C] pixel arrays (a may be one image against a
    batch b) -> float32 SSIM map of b's shape."""
    k = _gaussian_kernel(5, 1.5)
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2

    def fn(a, b):
        mu_a, mu_b, e_aa, e_bb, e_ab = filtered_moments(
            a.to(torch.float32), b.to(torch.float32), lambda x: _filter2d_sep(x, k)
        )
        mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
        sig_a = e_aa - mu_a2
        sig_b = e_bb - mu_b2
        sig_ab = e_ab - mu_ab
        num = (2 * mu_ab + c1) * (2 * sig_ab + c2)
        den = (mu_a2 + mu_b2 + c1) * (sig_a + sig_b + c2)
        return num / den

    return _batched(fn, a, b)


def calculate_ssim(orig, comp, max_value: float = 255.0, *, device=None) -> float:
    """Mean SSIM over pixels and channels (ImageMagick-compare analog)."""
    a, b = image_pair(orig, comp, device)
    return float(torch.mean(_ssim_map(a, b, max_value=max_value)))


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 box mean over the H and W axes of [..., H, W, C]; odd tails are
    dropped."""
    h, w = img.shape[-3] // 2 * 2, img.shape[-2] // 2 * 2
    x = img[..., :h, :w, :]
    return 0.25 * (x[..., 0::2, 0::2, :] + x[..., 1::2, 0::2, :] + x[..., 0::2, 1::2, :] + x[..., 1::2, 1::2, :])


def ms_ssim_scales(a: torch.Tensor, b: torch.Tensor, max_value: float = 255.0) -> list:
    """Per-scale MS-SSIM terms of [N, H, W, C] pixel batches (a may be one
    image): [(value [N] float32, weight)], contrast-structure at the four
    fine scales and full SSIM at the coarsest, stopping where the smaller
    side falls under 11 (the whole batch shares its geometry)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    k = _gaussian_kernel(5, 1.5)
    c2 = (0.03 * max_value) ** 2
    vals = []
    for i, w in enumerate(_MSSSIM_WEIGHTS):
        if min(a.shape[-3], a.shape[-2]) < 11:
            break
        if i == len(_MSSSIM_WEIGHTS) - 1:
            v = torch.mean(_ssim_map(a, b, max_value=max_value), dim=(-3, -2, -1))
        else:
            mu_a, mu_b, e_aa, e_bb, e_ab = filtered_moments(a, b, lambda x: _filter2d_sep(x, k))
            # clamp variances: f32 cancellation can make them slightly
            # negative, which pushed per-scale contrast terms above 1
            sig_a = torch.clamp(e_aa - mu_a * mu_a, min=0.0)
            sig_b = torch.clamp(e_bb - mu_b * mu_b, min=0.0)
            sig_ab = e_ab - mu_a * mu_b
            v = torch.mean((2 * sig_ab + c2) / (sig_a + sig_b + c2), dim=(-3, -2, -1))
            a = _downsample2x(a)
            b = _downsample2x(b)
        vals.append((v, w))
    return vals


def calculate_ms_ssim(orig, comp, max_value: float = 255.0, *, device=None) -> float:
    """Multi-scale SSIM (Wang et al. 2003), 5 scales; the per-scale terms
    are combined on the host in Python floats, as in the reference."""
    a, b = image_pair(orig, comp, device)
    out = 1.0
    for v, w in ms_ssim_scales(a[None], b[None], max_value):
        out *= min(max(float(v[0]), 1e-6), 1.0) ** w
    return float(out)
