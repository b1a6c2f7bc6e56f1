"""Orthonormal DCT-II transforms over the last two dims, and zigzag tables.

Port of `jxl_tpu/transforms/dct.py`. Every block size is the separable
product C = D_n @ X @ D_m^T, batched over the leading dimensions. D is
orthogonal, so the inverse is the transpose. The matrices and the zigzag
orders are built in numpy exactly as the reference builds them.

A CPU tensor runs the two products as torch.matmul calls, in full float32
(TF32 is off, see core.device): the path the CPU tests hold against the
reference. A CUDA tensor runs the hand-written kernel `csrc/dct.cu` (D1)
on the caller's view as it is, strides and all: one launch for sides up
to 64, two (rows, then columns) above. `plan` lays the launches out, the
bases live on the device (`device_basis`); `cuda_build.launch_counts`
counts the launches (entry `dct2d`).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from jxl_tpu_torch.cuda_build import launch, route


@lru_cache(maxsize=None)
def _dct_matrix_np(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    mat = np.cos(np.pi * (j + 0.5) * k / n)
    mat *= np.sqrt(2.0 / n)
    mat[0] *= np.sqrt(0.5)
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def device_basis(n: int, device: torch.device) -> torch.Tensor:
    """[2, n, n] float32 on `device`: D_n and D_n^T, uploaded once per
    (n, device)."""
    d = _dct_matrix_np(n)
    return torch.from_numpy(np.stack([d, d.T])).to(device)


def dct_matrix(n: int, device) -> torch.Tensor:
    """[n, n] orthonormal DCT-II matrix on `device` (cached: do not write to it)."""
    return device_basis(n, torch.device(device))[0]


def dct2d_plain(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The 2D DCT (or its inverse) as two torch.matmul calls: the CPU path."""
    n, m = x.shape[-2], x.shape[-1]
    dn, dm = dct_matrix(n, x.device), dct_matrix(m, x.device)
    if inverse:
        return torch.matmul(torch.matmul(dn.T, x), dm)
    return torch.matmul(torch.matmul(dn, x), dm.T)


def dct2d(blocks: torch.Tensor) -> torch.Tensor:
    """2D DCT over the last two dims: [..., n, m] -> [..., n, m]."""
    return route("dct2d", blocks.device, dct2d_cuda, dct2d_plain)(blocks, inverse=False)


def idct2d(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2D DCT over the last two dims (transpose of dct2d)."""
    return route("idct2d", coeffs.device, dct2d_cuda, dct2d_plain)(coeffs, inverse=True)


ONE_LAUNCH_MAX = 64  # sides up to this run both passes in one launch
MAX_SIDE = 2048  # a column strip of this many rows still fits a CTA
CTA_SAMPLES = 4096  # samples a CTA holds in shared memory
MAX_NB = 256  # blocks a CTA (csrc/dct.cu)
MAX_RANK = 8  # 6 batch dims and the block's two
SMEM_LIMIT = 48 * 1024 - 8 * MAX_NB  # dynamic shared memory a CTA takes without opting in, less the block bases


class Launch(NamedTuple):
    """One launch of D1 over blocks [rows, cols] of a strided view: the
    first pass contracts `rows` with D_rows, and with `two` the second
    contracts `cols` with D_cols, writing [rows, cols] blocks; without it
    the launch writes D_rows X transposed, [cols, rows] blocks."""

    batch: tuple  # ((size, stride), ...), outermost first, merged
    rows: int
    cols: int
    row_stride: int
    col_stride: int
    two: bool
    nb: int  # blocks a CTA


def _merge(dims) -> tuple:
    """(size, stride) pairs without size-1 dims, neighbours merged where
    one steps over the other exactly; at least one pair."""
    out = []
    for size, stride in dims:
        if size == 1:
            continue
        if out and out[-1][1] == size * stride:
            out[-1] = (out[-1][0] * size, stride)
        else:
            out.append((size, stride))
    return tuple(out) or ((1, 0),)


def _strip(side: int, rows: int) -> int:
    """Columns a CTA takes of a block whose rows are contracted alone: the
    largest divisor of `side` up to 16 with rows x it <= CTA_SAMPLES."""
    return max(d for d in range(1, 17) if side % d == 0 and rows * d <= CTA_SAMPLES)


def smem_bytes(nb: int, rows: int, cols: int) -> int:
    """Dynamic shared memory of a CTA of D1 over nb blocks [rows, cols]: X
    holds (rows + 1) x cols floats a block (rounded up to 16 bytes), T
    (cols + 1) x rows."""
    return 4 * (-(-nb * (rows + 1) * cols // 4) * 4 + nb * (cols + 1) * rows)


def _launch_of(batch, rows, cols, row_stride, col_stride, two) -> Launch:
    batch = _merge(batch)
    if math.prod(s for s, _ in batch) >= 1 << 31:
        raise ValueError(f"dct2d_cuda: {batch} holds 2^31 blocks or more")
    nb = max(1, min(MAX_NB, CTA_SAMPLES // (rows * cols)))
    while nb > 1 and smem_bytes(nb, rows, cols) > SMEM_LIMIT:
        nb //= 2
    return Launch(batch, rows, cols, row_stride, col_stride, two, nb)


@lru_cache(maxsize=1024)
def plan(shape: tuple, strides: tuple, dtype) -> tuple:
    """The launches that transform a view of `shape` / `strides` (in
    elements) over its last two dims: one for sides up to ONE_LAUNCH_MAX,
    else two, the first writing an intermediate contiguous [..., m, n]
    that the second reads. Empty for an empty view. Raises ValueError on
    a dtype other than float32, fewer than 2 or more than MAX_RANK dims,
    or a side above MAX_SIDE. Cached: a codec passes the same few views
    again and again."""
    if dtype != torch.float32:
        raise ValueError(f"dct2d_cuda takes float32, not {dtype}")
    if not 2 <= len(shape) <= MAX_RANK:
        raise ValueError(f"dct2d_cuda takes 2 to {MAX_RANK} dims, not {len(shape)}")
    n, m = shape[-2], shape[-1]
    if max(n, m) > MAX_SIDE:
        raise ValueError(f"dct2d_cuda takes sides up to {MAX_SIDE}, not {n} x {m}")
    if 0 in shape:
        return ()
    lead = list(zip(shape[:-2], strides[:-2]))
    sr, sq = strides[-2], strides[-1]
    if max(n, m) <= ONE_LAUNCH_MAX:
        return (_launch_of(lead, n, m, sr, sq, True),)
    s1, s2 = _strip(m, n), _strip(n, m)
    nlead = math.prod(shape[:-2])
    return (
        _launch_of(lead + [(m // s1, s1 * sq)], n, s1, sr, sq, False),
        _launch_of([(nlead, m * n), (n // s2, s2)], m, s2, n, 1, False),
    )


@lru_cache(maxsize=None)
def _basis_ptr(n: int, device: torch.device, transposed: bool) -> int:
    """Address of D_n (or D_n^T) in `device_basis(n, device)`."""
    return device_basis(n, device)[int(transposed)].data_ptr()


@lru_cache(maxsize=1024)
def _meta(lau: Launch):
    """The launch's arguments as csrc/dct.cu reads them: nbatch, R, Q, row
    and column stride, two, nb, the block count, then (size, stride) of
    each batch dim."""
    meta = [len(lau.batch), lau.rows, lau.cols, lau.row_stride, lau.col_stride, int(lau.two), lau.nb,
            math.prod(s for s, _ in lau.batch)]
    for size, stride in lau.batch:
        meta += [size, stride]
    return (ctypes.c_longlong * len(meta))(*meta)


def _run(x: torch.Tensor, out: torch.Tensor, lau: Launch, inverse: bool) -> None:
    # each pass reads M^T, M its matrix: D^T when forward, D when inverse
    mr = _basis_ptr(lau.rows, x.device, not inverse)
    mq = _basis_ptr(lau.cols, x.device, not inverse) if lau.two else mr
    launch("dct2d", x.device, x.data_ptr(), out.data_ptr(), mr, mq, _meta(lau))


def dct2d_cuda(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The 2D DCT (or its inverse) of the CUDA float32 view `x` over its
    last two dims, through D1: a contiguous [..., n, m] result."""
    launches = plan(x.shape, x.stride(), x.dtype)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if len(launches) == 1:
        _run(x, out, launches[0], inverse)
    elif launches:
        mid = torch.empty((*x.shape[:-2], x.shape[-1], x.shape[-2]), dtype=torch.float32, device=x.device)
        _run(x, mid, launches[0], inverse)
        _run(mid, out, launches[1], inverse)
    return out


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
