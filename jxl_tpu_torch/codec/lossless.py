"""Modular mode: lossless (d = 0) and modular-lossy (d > 0) coding (port of
`jxl_tpu/codec/lossless.py`).

- reversible colour: YCoCg-R integer lifting (arithmetic shifts on int32);
- per-channel predictor picked on the rate proxy from none / west /
  unclamped gradient / north: every inverse is a prefix sum, so decode
  stays parallel;
- per-(channel, 8x8 block) activity classes (`layout.LL_EDGES` buckets of
  the block's nonzero residuals) coded first; the pixel contexts condition
  on them and the block axis is sorted by class;
- modular-lossy quantises the YCoCg-R planes by `modular_steps(d)` first
  and runs the same machinery on the quantised planes; the steps are
  (1, 1, 1) up to d ~ 0.15, so d = 0 is the lossless point of that law.

Integer end to end: d = 0 round trips exactly. The steps are computed on
the host in float32 from the header's distance, so the port's encoder and
decoder agree on every device.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from jxl_tpu_torch.codec.layout import LL_EDGES, LL_Q, lossless_layout
from jxl_tpu_torch.entropy.tokens import tokenize, zigzag_map, zigzag_unmap


MOD_COEFS = (3.6, 5.4, 0.85)  # default (ky, kc, p) of the modular-lossy step law


def _mod_coefs() -> tuple[float, float, float]:
    """Step-law coefficients (ky, kc, p) of the modular-lossy quantiser:
    step_c = max(1, round(k_c * d^p)). JXL_TPU_MOD_Q='ky,kc,p' overrides
    (read by the encoder and the decoder alike: it is not signalled)."""
    v = os.environ.get("JXL_TPU_MOD_Q")
    if v:
        ky, kc, p = (float(x) for x in v.split(","))
        return ky, kc, p
    return MOD_COEFS


def modular_steps(distance, coefs=None) -> torch.Tensor:
    """Distance -> int32 [3] quantisation steps (Y, Co, Cg) on the CPU:
    max(1, round(k * d^p)) per channel in float32, exactly (1, 1, 1) at
    d <= ~0.15. `coefs` (ky, kc, p) defaults to `_mod_coefs()`."""
    ky, kc, p = _mod_coefs() if coefs is None else coefs
    d = torch.clamp(torch.tensor(float(distance), dtype=torch.float32), min=0.0)
    dp = d**p
    raw = torch.stack([ky * dp, kc * dp, kc * dp])
    return torch.clamp(torch.round(raw).to(torch.int32), min=1)


def ycocg_forward(rgb: torch.Tensor) -> torch.Tensor:
    """u8 [H, W, 3] -> int32 [3, H, W] (Y, Co, Cg). Exactly reversible."""
    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    return torch.stack([y, co, cg])


def _ycocg_inverse_i32(planes: torch.Tensor) -> torch.Tensor:
    """int32 [3, H, W] (Y, Co, Cg) -> int32 [H, W, 3] RGB (unclipped)."""
    y, co, cg = planes[0], planes[1], planes[2]
    t = y - (cg >> 1)
    g = cg + t
    b = t - (co >> 1)
    r = b + co
    return torch.stack([r, g, b], dim=-1)


def ycocg_inverse(planes: torch.Tensor) -> torch.Tensor:
    """int32 [3, H, W] -> u8 [H, W, 3]."""
    return _ycocg_inverse_i32(planes).to(torch.uint8)


def _shifted(planes: torch.Tensor):
    """(W, N, NW) neighbours of [3, H, W] planes, zero outside."""
    w = F.pad(planes, (1, 0))[:, :, :-1]
    n = F.pad(planes, (0, 0, 1, 0))[:, :-1, :]
    nw = F.pad(planes, (1, 0, 1, 0))[:, :-1, :-1]
    return w, n, nw


def grad_residual(planes: torch.Tensor) -> torch.Tensor:
    """r = x - W - N + NW per [3, H, W] plane (unclamped gradient)."""
    w, n, nw = _shifted(planes)
    return planes - w - n + nw


def _cumsum32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 prefix sum (torch.cumsum widens int32 to int64; the
    reference's stays int32, and the cast back wraps the same way)."""
    return torch.cumsum(x, dim=dim).to(torch.int32)


def grad_reconstruct(res: torch.Tensor) -> torch.Tensor:
    """Inverse of grad_residual: separable 2D prefix sum (exact, int32)."""
    return _cumsum32(_cumsum32(res, 1), 2)


def _blockify(res: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """[3, h, w] -> 8-padded block-major [3, nbl, 64] (pad residuals 0)."""
    h, w = res.shape[-2:]
    rp = F.pad(res, (0, wp - w, 0, hp - h))
    return rp.reshape(3, hp // 8, 8, wp // 8, 8).permute(0, 1, 3, 2, 4).reshape(3, (hp // 8) * (wp // 8), 64)


def _unblockify(blocks: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Inverse of _blockify (padded planes [3, hp, wp])."""
    return blocks.reshape(3, hp // 8, wp // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(3, hp, wp)


def ll_step_ctx(lay, q_sorted: torch.Tensor) -> torch.Tensor:
    """[T] per-step contexts: the static flag-section prefix, then the
    activity-conditioned pixel contexts 3 + q * 3 + c of each step's first
    token (the lossless twin of encode._step_ctx_v8)."""
    dev = q_sorted.device
    static_a = torch.from_numpy(lay["step_ctx"][: lay["t_a"]].astype("int64")).to(dev)
    chan = torch.from_numpy(lay["ll_step_chan"].astype("int64")).to(dev)
    flat = chan * lay["nbl"] + torch.from_numpy(lay["ll_step_blk"].astype("int64")).to(dev)
    qs = q_sorted.reshape(-1)[flat].to(torch.int64)
    return torch.cat([static_a, 3 + chan + qs * 3])


def lossless_tokens(rgb, *, height: int, width: int, distance=None, planes=None, coefs=None):
    """Pixels (u8 [H, W, 3] tensor) -> (token, nbits, mantissa [n_tokens]
    int32, params int, q_sorted [3, nbl]).

    distance=None is the exact lossless mode; a distance quantises the
    YCoCg-R planes by modular_steps(distance, coefs) first (identity at
    d = 0). planes (int32 [3, H, W]) bypasses the colour transform: the
    palette mode codes [index, 0, 0] here.

    params: per-channel predictor mode, 2 bits each (bits 2c..2c+1): 0 none,
    1 west, 2 gradient, 3 north, picked per channel by the smallest rate
    proxy (first index on ties, as the reference's argmin). Reading the
    modes back synchronises with the device."""
    from jxl_tpu_torch.codec.encode import _bits_proxy, bucket_perm

    if planes is None:
        planes = ycocg_forward(rgb)
    if distance is not None:
        steps = modular_steps(distance, coefs).to(planes.device, torch.float32)[:, None, None]
        planes = torch.round(planes.to(torch.float32) / steps).to(torch.int32)
    w_, n_, nw_ = _shifted(planes)
    res_all = torch.stack([planes, planes - w_, planes - w_ - n_ + nw_, planes - n_])  # [4 mode, 3 ch, H, W]
    mode_costs = torch.sum(_bits_proxy(res_all), dim=(2, 3))  # [4 mode, 3 ch]
    modes = torch.argmin(mode_costs, dim=0).tolist()
    params = modes[0] | (modes[1] << 2) | (modes[2] << 4)
    res = torch.stack([res_all[m, c] for c, m in enumerate(modes)])

    lay = lossless_layout(height, width, 128)  # geometry only
    hp, wp, nbl = lay["hp"], lay["wp"], lay["nbl"]
    blocks = _blockify(res, hp, wp)  # [3, nbl, 64]
    nnzb = torch.sum(blocks != 0, dim=-1)
    q = torch.zeros_like(nnzb)
    for e in LL_EDGES:
        q = q + (nnzb >= e).to(q.dtype)
    perm = bucket_perm(q, nbl)
    blocks_sorted = torch.gather(blocks, 1, perm[:, :, None].expand(3, nbl, 64))
    q_sorted = torch.gather(q, 1, perm)
    values = torch.cat([q.reshape(-1).to(torch.int32), zigzag_map(blocks_sorted.reshape(3, -1)).reshape(-1)])
    token, nbits, mant = tokenize(values)
    return token, nbits, mant, params, q_sorted


def reconstruct_lossless(values: torch.Tensor, params: int, *, height: int, width: int, distance=None, pal=None):
    """Decoded value stream [n_tokens] -> RGB u8 [H, W, 3].

    params: the per-channel predictor modes (see lossless_tokens).
    distance (or None) scales the reconstructed quantised planes back by
    modular_steps(distance) and clips in RGB (a no-op at d = 0). pal (u8
    [256, 3] tensor, palette mode): plane 0 holds palette indices and the
    pixels are the row gather pal[idx]."""
    from jxl_tpu_torch.codec.encode import bucket_perm

    lay = lossless_layout(height, width, 128)
    hp, wp, nbl = lay["hp"], lay["wp"], lay["nbl"]
    q = torch.clamp(values[: 3 * nbl].to(torch.int64).reshape(3, nbl), 0, LL_Q - 1)
    inv_perm = torch.argsort(bucket_perm(q, nbl), dim=1)
    blocks_sorted = zigzag_unmap(values[3 * nbl :]).reshape(3, nbl, 64)
    blocks = torch.gather(blocks_sorted, 1, inv_perm[:, :, None].expand(3, nbl, 64))
    res = _unblockify(blocks, hp, wp)
    chans = []
    for c in range(3):
        mode = (int(params) >> (2 * c)) & 3
        r = res[c]
        if mode == 1:
            r = _cumsum32(r, 1)
        elif mode == 2:
            r = _cumsum32(_cumsum32(r, 1), 0)
        elif mode == 3:
            r = _cumsum32(r, 0)
        chans.append(r)
    planes = torch.stack(chans)[:, :height, :width]
    if pal is not None:
        return pal[torch.clamp(planes[0], 0, 255).to(torch.int64)]
    if distance is not None:
        steps = modular_steps(distance).to(planes.device)[:, None, None]
        return torch.clamp(_ycocg_inverse_i32(planes * steps), 0, 255).to(torch.uint8)
    return ycocg_inverse(planes)
