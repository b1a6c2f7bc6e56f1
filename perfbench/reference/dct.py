"""Orthonormal DCT-II transforms as batched matmuls, and zigzag tables.

Port of `jxl_tpu/transforms/dct.py`. Every block size is a pair of small
float32 matrix products, C = D_n @ X @ D_m^T, batched over the leading
dimensions. D is orthogonal, so the inverse is the transpose. The matrices
and the zigzag orders are built in numpy exactly as the reference builds
them; the products run in full float32 unless `matmul_precision` says
otherwise.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

# "fp32": full float32 products (the precision the configurations state);
# "fp32_reordered": the same products in the other association, D_n @ (X @
# D_m^T), a sound float32 variant that rounds differently (as a fused or
# reordered kernel would); "tf32": each operand rounded to TF32's 10
# mantissa bits first, as a tensor core does with TF32 on. Only the
# calibration of the judge's limits sets the last two.
_PRECISION = {"mm": "fp32"}


@contextmanager
def matmul_precision(name: str):
    """Run the DCTs inside at `name` ("fp32", "fp32_reordered" or "tf32")."""
    if name not in ("fp32", "fp32_reordered", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    old = _PRECISION["mm"]
    _PRECISION["mm"] = name
    try:
        yield
    finally:
        _PRECISION["mm"] = old


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _PRECISION["mm"] == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return torch.matmul(a, b)


@lru_cache(maxsize=None)
def _dct_matrix_np(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    mat = np.cos(np.pi * (j + 0.5) * k / n)
    mat *= np.sqrt(2.0 / n)
    mat[0] *= np.sqrt(0.5)
    return mat.astype(np.float32)


def dct_matrix(n: int, device) -> torch.Tensor:
    """[n, n] orthonormal DCT-II matrix on `device`."""
    return torch.from_numpy(_dct_matrix_np(n)).to(device)


def dct2d(blocks: torch.Tensor) -> torch.Tensor:
    """2D DCT over the last two dims: [..., n, m] -> [..., n, m]."""
    n, m = blocks.shape[-2], blocks.shape[-1]
    dn, dm = dct_matrix(n, blocks.device), dct_matrix(m, blocks.device)
    if _PRECISION["mm"] == "fp32_reordered":
        return _mm(dn, _mm(blocks, dm.T))
    return _mm(_mm(dn, blocks), dm.T)


def idct2d(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2D DCT over the last two dims (transpose of dct2d)."""
    n, m = coeffs.shape[-2], coeffs.shape[-1]
    dn, dm = dct_matrix(n, coeffs.device), dct_matrix(m, coeffs.device)
    if _PRECISION["mm"] == "fp32_reordered":
        return _mm(dn.T, _mm(coeffs, dm))
    return _mm(_mm(dn.T, coeffs), dm)


@lru_cache(maxsize=None)
def zigzag_order(n: int, m: int) -> np.ndarray:
    """Flat indices of an n x m coefficient block in zigzag (low->high freq) order.

    Generalized JPEG zigzag: sort by diagonal (u+v), alternating direction.
    Returns int32 array of length n*m with flat indices into the row-major block.
    """
    coords = [(u, v) for u in range(n) for v in range(m)]
    coords.sort(key=lambda uv: (uv[0] + uv[1], uv[1] if (uv[0] + uv[1]) % 2 == 0 else uv[0]))
    return np.array([u * m + v for u, v in coords], dtype=np.int32)


@lru_cache(maxsize=None)
def inverse_zigzag_order(n: int, m: int) -> np.ndarray:
    """Permutation inverse of zigzag_order: position of each flat index."""
    zz = zigzag_order(n, m)
    inv = np.empty_like(zz)
    inv[zz] = np.arange(n * m, dtype=np.int32)
    return inv


def permute_last(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """out[..., i] = x[..., perm[i]] (an index gather; exact for any dtype)."""
    return x[..., torch.as_tensor(np.asarray(perm, np.int64), device=x.device)]
