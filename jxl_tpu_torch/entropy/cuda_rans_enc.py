"""Grouped rANS encode with in-order stream emission: CUDA kernel wrapper
(kernel B3).

Replaces `jxl_tpu/entropy/pallas_rans_enc.py:encode_grouped_pallas`, the
Pallas TPU encode scan. The kernel is `csrc/rans_enc.cu`: one two-warp
CTA per 128-lane group walking the steps back to front, one warp running
the states and placing the emitted words, the other packing the mantissa
bytes, each with its own shared-memory rings refilled ahead with cp.async
and its outputs staged and written to their back-filled slots; its source
note says what bounds it on an H100 and what it measures there. The plain
version is `encode_grouped_plain`, with the same arguments and outputs.

Outputs (both versions): words [G, capw] int32 with group g's stream at
[capw - wcount_g, capw) in decoder consumption order; mbytes [G, capm]
int32, same layout; states [lanes] int64; wcounts [G], mcounts [G] int32.
A count past its cap means the bucket overflowed: nothing was written
outside it. `encode_grouped_cuda` then launches again with the caps grown
to the reported counts.
"""

from __future__ import annotations

import ctypes

import torch

from jxl_tpu_torch.entropy.cuda_rans import check_tensor, i32_to_u32
from jxl_tpu_torch.entropy.grouped import (
    GROUP,
    MAX_NBYTES,
    n_groups,
    pack_mantissa_grouped,
    rans_encode_grouped,
)
from jxl_tpu_torch.entropy.tokens import ALPHABET


def _r128(v: int) -> int:
    return -(-v // GROUP) * GROUP


def enc_caps(T: int, lanes: int) -> tuple[int, int]:
    """Per-group bucket sizes. Words have a hard bound (the state grows by
    at most 12 bits per token, so at most ceil(0.75*T)+1 renorms per lane);
    mantissas budget 1/3 byte per token, generous for distances >= ~0.3
    (an overflow is detected from the counts and re-launched larger)."""
    capw = _r128(min(T * GROUP, (3 * T * GROUP) // 4 + 2 * GROUP))
    capm = _r128(min(MAX_NBYTES * T * GROUP, max(4096, (T * GROUP) // 3)))
    return capw, capm


def encode_grouped_plain(tokp, mant, rows, *, T: int, lanes: int, capw: int, capm: int):
    """Plain torch version of the encode kernel (any device)."""
    words, wcounts, states = rans_encode_grouped(tokp[: T * lanes], rows, lanes, capw)
    mbytes, mcounts = pack_mantissa_grouped(tokp[: T * lanes], mant[: T * lanes], lanes, capm)
    return words, mbytes, states, wcounts, mcounts


def _launch(tokp, mant, rows, *, T: int, lanes: int, capw: int, capm: int):
    from jxl_tpu_torch.cuda_build import load

    G = lanes // GROUP
    dev = tokp.device
    lib = load("rans_enc")
    fn = lib.jxl_rans_encode
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        words = torch.zeros((G, capw), dtype=torch.int32, device=dev)
        mbytes = torch.zeros((G, capm), dtype=torch.int32, device=dev)
        states = torch.empty(lanes, dtype=torch.int32, device=dev)
        counts = torch.empty((2, G), dtype=torch.int32, device=dev)
        err = fn(
            tokp.data_ptr(), mant.data_ptr(), rows.data_ptr(), T, G, capw, capm,
            words.data_ptr(), mbytes.data_ptr(), states.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rans_encode kernel launch failed: CUDA error {err}")
    encode_grouped_cuda.launches += 1
    return words, mbytes, i32_to_u32(states), counts[0], counts[1]


def encode_grouped_cuda(tokp, mant, rows, *, T: int, lanes: int, capw: int, capm: int):
    """rANS-encode the padded token stream tokp [T*lanes] int32 with its
    mantissas mant [T*lanes] int32 (< 2^24) under rows [>= T, 128] int32.

    CUDA tensors run the kernel, CPU tensors the plain version. If a
    bucket overflows, runs once more with caps grown to the counts (the
    returned buckets then have the grown widths)."""
    n_groups(lanes)  # validates the lane count
    dev = tokp.device
    check_tensor("tokp", tokp, torch.int32, (T * lanes,), dev)
    check_tensor("mant", mant, torch.int32, (T * lanes,), dev)
    check_tensor("rows", rows, torch.int32, (None, GROUP), dev)
    if rows.shape[0] < T:
        raise ValueError(f"rows has {rows.shape[0]} steps, fewer than T={T}")
    if capw % GROUP or capm % GROUP or capw <= 0 or capm <= 0:
        raise ValueError(f"caps ({capw}, {capm}) must be positive multiples of {GROUP}")
    lo, hi = torch.stack([tokp.min(), tokp.max()]).tolist() if T > 0 else (0, 0)
    if lo < 0 or hi >= ALPHABET:
        raise ValueError(f"tokens must lie in [0, {ALPHABET}), got [{lo}, {hi}]")
    if dev.type == "cpu":
        run = encode_grouped_plain
    elif dev.type == "cuda":
        run = _launch
    else:
        raise ValueError(f"encode_grouped_cuda: unsupported device {dev}")
    out = run(tokp, mant, rows, T=T, lanes=lanes, capw=capw, capm=capm)
    need = torch.stack([out[3].max(), out[4].max()]).tolist()
    if need[0] > capw or need[1] > capm:
        out = run(
            tokp, mant, rows, T=T, lanes=lanes,
            capw=max(capw, _r128(need[0])), capm=max(capm, _r128(need[1])),
        )
    return out


encode_grouped_cuda.launches = 0
