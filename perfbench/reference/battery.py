"""The sweep's metric battery over a whole RD row (port of
`jxl_tpu/metrics/battery.py`).

MSE, SSIM, MS-SSIM, Butteraugli (max, 3-norm) and the SSIMULACRA2 feature
error for one original against a batch of decoded images `[N, H, W, 3]`:
the reference's `lax.map` over the row becomes the leading batch axis of
every filter call, reductions run per image, and the `[N, 6]` result comes
to the host in one copy. PSNR and SSIMULACRA2's deadzone and power are
applied there, in Python floats (`_metrics_dict`).

On a CUDA device every intermediate stays on the card; the host waits only
in finalize().
"""

from __future__ import annotations

import torch

from perfbench.reference.perceptual import (
    _butteraugli_map,
    _ssimulacra2_features,
    butteraugli_norms,
    ssimulacra2_error,
    ssimulacra2_score,
)
from perfbench.reference.quality import _mse, _ssim_map, image_pair, ms_ssim_scales, psnr_from_mse

# images x pixels per battery call: a longer row is scored in chunks of the
# batch axis (a 512x768 row of up to 42 points is one chunk)
_CHUNK_PIXELS = 1 << 24


def _ms_ssim_t(a: torch.Tensor, b: torch.Tensor, max_value: float = 255.0) -> torch.Tensor:
    """MS-SSIM [N] as float32 tensors (the battery's form: the per-scale
    terms clipped and combined on the device)."""
    out = torch.ones(b.shape[0], dtype=torch.float32, device=b.device)
    for v, w in ms_ssim_scales(a, b, max_value):
        out = out * torch.clamp(v, 1e-6, 1.0) ** w
    return out


def _battery_core(orig_u8: torch.Tensor, comp_u8: torch.Tensor) -> torch.Tensor:
    """orig [1, H, W, 3] u8 against comp [N, H, W, 3] u8 -> [N, 6] float32:
    (mse, ssim, ms_ssim, butteraugli max, butteraugli 3-norm, ssimulacra2
    feature error)."""
    mse = _mse(orig_u8, comp_u8)
    ssim = torch.mean(_ssim_map(orig_u8, comp_u8), dim=(-3, -2, -1))
    ms_ssim = _ms_ssim_t(orig_u8, comp_u8)
    ba_max, ba_p3 = butteraugli_norms(_butteraugli_map(orig_u8, comp_u8))
    s2_err = ssimulacra2_error(_ssimulacra2_features(orig_u8, comp_u8))
    return torch.stack([mse, ssim, ms_ssim, ba_max, ba_p3, s2_err], dim=1)


def _battery_grid(orig_u8: torch.Tensor, comp_stack: torch.Tensor) -> torch.Tensor:
    """Battery for a whole RD row against one original: [H, W, 3] and
    [N, H, W, 3] u8 on one device -> [N, 6] float32 there."""
    h, w = comp_stack.shape[1:3]
    chunk = max(1, _CHUNK_PIXELS // (h * w))
    o = orig_u8.reshape(1, h, w, 3)
    return torch.cat([_battery_core(o, comp_stack[i : i + chunk]) for i in range(0, comp_stack.shape[0], chunk)])


def _metrics_dict(v) -> dict:
    """One battery row (six floats) -> the sweep's metric dict."""
    mse = float(v[0])
    return {
        "mse": mse,
        "psnr": psnr_from_mse(mse),
        "ssim": float(v[1]),
        "ms_ssim": float(v[2]),
        "butteraugli": float(v[3]),
        "butteraugli_pnorm": float(v[4]),
        "ssimulacra2": ssimulacra2_score(float(v[5])),
    }


def metric_battery_grid_async(orig, comp_stack, *, device=None):
    """Enqueue the whole-row battery now; returns finalize() -> list of
    metric dicts (one per row point). orig [H, W, 3] and comp_stack
    [N, H, W, 3] u8, tensors (device taken from them) or arrays with
    `device`."""
    o, c = image_pair(orig, comp_stack, device)
    vecs = _battery_grid(o, c)

    def finalize() -> list:
        v = vecs.cpu().tolist()
        return [_metrics_dict(row) for row in v]

    return finalize


def metric_battery_async(orig, comp, *, device=None):
    """Enqueue the battery of one (orig, comp) pair now; returns
    finalize() -> metrics dict."""
    o, c = image_pair(orig, comp, device)
    fin = metric_battery_grid_async(o, c[None])
    return lambda: fin()[0]


def metric_battery(orig, comp, *, device=None) -> dict:
    """All sweep metrics for one (orig, comp) pair: one device pass, one
    copy of six floats to the host."""
    return metric_battery_async(orig, comp, device=device)()
