"""The modular / VarDCT pre-screen's count: CUDA kernel wrapper and its
plain version.

`screen_count(rgb_t)` counts, over the grid `rgb_t[::s, ::s]` of a u8
[H, W, 3] frame, the grid pixels (i, j), i >= 1, j >= 1, whose three bytes
equal both their west and their north grid neighbour's, and returns
(count, n), n the number of such positions. The stride s is 1, or 4 above
2^24 pixels (`screen_stride`), as in the reference. A CUDA tensor runs the
kernel `csrc/screen.cu` (one launch into a zeroed u64, read back once); a
CPU tensor runs `screen_plain`, the same count in torch ops. The kernel
replaces no TPU kernel: `jxl_tpu` computes the screen in host numpy.
"""

from __future__ import annotations

import torch

from jxl_tpu_torch.cuda_build import check_tensor, launch, route

SUBSAMPLE_ABOVE = 1 << 24  # pixels; larger frames are screened at stride 4


def screen_stride(h: int, w: int) -> int:
    return 4 if h * w > SUBSAMPLE_ABOVE else 1


def screen_plain(rgb_t: torch.Tensor, s: int) -> int:
    """Plain torch version of the kernel's count (any device)."""
    a = rgb_t[::s, ::s]
    eqw = (a[:, 1:] == a[:, :-1]).all(dim=2)
    eqn = (a[1:, :] == a[:-1, :]).all(dim=2)
    return int((eqw[1:, :] & eqn[:, 1:]).sum())


def _launch(rgb_t: torch.Tensor, s: int, out: torch.Tensor) -> None:
    """Add the count of the CUDA frame `rgb_t` at stride `s` to `out`, one
    int64 on its device, on the current stream (no read-back)."""
    launch("screen", rgb_t.device, rgb_t.data_ptr(), rgb_t.shape[0], rgb_t.shape[1], s, out.data_ptr())


def _screen_kernel(rgb_t: torch.Tensor, s: int) -> int:
    out = torch.zeros(1, dtype=torch.int64, device=rgb_t.device)
    _launch(rgb_t, s, out)
    return int(out.item())


def screen_count(rgb_t: torch.Tensor) -> tuple[int, int]:
    """(count, n) of the pre-screen over the contiguous u8 [H, W, 3] frame
    `rgb_t`: the kernel on a CUDA tensor, the plain version on a CPU one.
    Raises ValueError on another dtype, shape or layout, or device."""
    run = route("screen_count", rgb_t.device, _screen_kernel, screen_plain)
    check_tensor("rgb", rgb_t, torch.uint8, (None, None, 3), rgb_t.device)
    h, w = rgb_t.shape[0], rgb_t.shape[1]
    s = screen_stride(h, w)
    n = max(0, -(-h // s) - 1) * max(0, -(-w // s) - 1)
    if n == 0:
        return 0, 0
    return run(rgb_t, s), n
