"""Device handling for the port's entry points.

`resolve_device` is where the main entry points (`codec.encode.encode_image`,
`codec.decode.decode_bytes*`) first touch a device. On CUDA it turns TF32
off for float32 matrix products and cuDNN convolutions
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`): the DCTs, the k-means cost
matrix and the colour transforms feed quantisers with ~1e-3 steps, which
is why the reference computes them at `Precision.HIGHEST`.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` (str or torch.device) as a torch.device, with TF32 off on
    CUDA. There is no default and no fallback: a CUDA device that is not
    available raises here."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
