"""Helpers shared by the port's parity tests (tests/test_torch_*.py).

The JAX package and the PyTorch port exchange data only as numpy arrays:
these helpers turn the JAX functions' inputs and outputs into the port's
tensors and back. Everything runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

GROUP = 128


def t32(a) -> torch.Tensor:
    """Any integer array -> contiguous int32 CPU tensor (u32 bit patterns wrap)."""
    return torch.from_numpy(np.asarray(a).astype(np.int64).astype(np.int32).copy())


def t64(a) -> torch.Tensor:
    """Any integer array -> int64 CPU tensor (u32 values stay nonnegative)."""
    return torch.from_numpy(np.asarray(a).astype(np.int64).copy())


def np_(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def stream_from_jax(token, mant, step_ctx, freq, cum):
    """JAX `_stream` outputs -> the port's (tokp int32, mant int32, rows int32)."""
    from jxl_tpu_torch.entropy.grouped import kernel_rows

    rows = kernel_rows(t32(step_ctx), t32(freq), t32(cum))
    return t32(token), t32(mant), rows


def front_pack(bucket, counts, width: int) -> np.ndarray:
    """Back-filled encode bucket [G, cap] (group g's stream at
    [cap - counts[g], cap)) -> decode buffer [G, width] int32 with each
    stream at the front of its row and a zero tail."""
    bucket = np.asarray(bucket)
    out = np.zeros((bucket.shape[0], width), np.int32)
    for g in range(bucket.shape[0]):
        c = int(counts[g])
        out[g, :c] = bucket[g, bucket.shape[1] - c :]
    return out


def carry_from_jax(st8, ptr16, G: int):
    """Pallas carry ([8, 128] u32 state tile, [16] i32 pointers) -> the
    port's (states [lanes] int64, ptrs [2, G] int32)."""
    st = np.asarray(st8)[:G].reshape(-1)
    p = np.asarray(ptr16)
    return t64(st), t32(np.stack([p[:G], p[8 : 8 + G]]))


def values_from_tokens(token, nbits, mant) -> np.ndarray:
    """Detokenised values of (token, nbits, mantissa) arrays."""
    tok = np.asarray(token).astype(np.int64)
    nb = np.asarray(nbits).astype(np.int64)
    return np.where(tok >= 32, (1 << nb) + np.asarray(mant).astype(np.int64), tok)
