"""Grouped rANS decode: CUDA kernel wrappers (kernels B1 and B2).

`decode_grouped_cuda` (B1, one stream) replaces
`jxl_tpu/entropy/pallas_rans.py:decode_grouped_pallas` and
`decode_grouped_batched_cuda` (B2, B same-geometry streams) replaces
`decode_grouped_pallas_batched`, the Pallas TPU decode scans. Both launch
the kernel of `csrc/rans_dec.cu` through its two C entry points: one
two-warp CTA per stream and 128-lane group, one warp running the states
(four lanes a thread, word ranks from warp ballots, the word stream and
step rows in shared-memory rings refilled ahead with cp.async), the other
turning the decoded symbols into values with the mantissa bytes; its
source note says what bounds it on an H100 and what it measures there.
The plain versions are `entropy/grouped.py:decode_grouped` and
`decode_grouped_batched`, with the same arguments and outputs.

Each wrapper runs the kernel for CUDA tensors and the plain version for
CPU tensors, and raises on anything else (`cuda_build.route`). There is no
fallback: a CUDA call that cannot launch raises. `cuda_build.launch_counts`
counts the launches (entries `rans_decode`, `rans_decode_batched`).

The Pallas kernel's 128-aligned windows, read-ahead slack and VMEM budget
have no counterpart: the CUDA kernel reads at the stream pointer itself
and treats reads past a bucket's end as 0, like the plain version.
"""

from __future__ import annotations

import torch

from jxl_tpu_torch.cuda_build import check_tensor, launch, route
from jxl_tpu_torch.entropy.grouped import GROUP, decode_grouped, decode_grouped_batched, n_groups


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bit pattern."""
    x = x.to(torch.int64)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _launch(entry: str, words_g, mant_g, states, rows, ptrs, *, T: int, lanes: int, B: int, lib=None):
    """Launch the decode kernel through C entry `entry` (`rans_decode` or
    `rans_decode_batched`; `lib`: another build of its source) on validated
    CUDA tensors; returns (values [B, T*lanes] int32, states [B, lanes]
    int64, ptrs [2, B*G] int32)."""
    G = n_groups(lanes)
    dev = words_g.device
    st_in = u32_to_i32(states)
    values = torch.empty((B, T * lanes), dtype=torch.int32, device=dev)
    st_out = torch.empty((B, lanes), dtype=torch.int32, device=dev)
    ptr_out = torch.empty((2, B * G), dtype=torch.int32, device=dev)
    launch(
        entry, dev, words_g.data_ptr(), words_g.shape[1], mant_g.data_ptr(), mant_g.shape[1], rows.data_ptr(), T,
        st_in.data_ptr(), ptrs.data_ptr(), G, *([B] if entry == "rans_decode_batched" else []), values.data_ptr(),
        st_out.data_ptr(), ptr_out.data_ptr(), lib=lib,
    )
    return values, i32_to_u32(st_out), ptr_out


def _decode_one(words_g, mant_g, states, rows, ptrs, *, T: int, lanes: int):
    values, st, p = _launch("rans_decode", words_g, mant_g, states, rows, ptrs, T=T, lanes=lanes, B=1)
    return values.reshape(T * lanes), st.reshape(lanes), p


def _decode_batched(words_g, mant_g, states, rows, ptrs, *, T: int, lanes: int):
    B = states.shape[0]
    return _launch("rans_decode_batched", words_g, mant_g, states, rows, ptrs, T=T, lanes=lanes, B=B)


def decode_grouped_cuda(
    words_g: torch.Tensor,
    mant_g: torch.Tensor,
    states: torch.Tensor,
    rows: torch.Tensor,
    ptrs: torch.Tensor,
    *,
    T: int,
    lanes: int,
):
    """Decode T scan steps of one stream (kernel B1; see
    grouped.decode_grouped for the arguments).

    words_g [G, capw] int32, mant_g [G, capm] int32, states [lanes] int64,
    rows [>= T, 128] int32, ptrs [2, G] int32 — all on one device. Returns
    (values [T*lanes] int32, states [lanes] int64, ptrs [2, G] int32)."""
    run = route("decode_grouped_cuda", words_g.device, _decode_one, decode_grouped)
    G = n_groups(lanes)
    dev = words_g.device
    check_tensor("words_g", words_g, torch.int32, (G, None), dev)
    check_tensor("mant_g", mant_g, torch.int32, (G, None), dev)
    check_tensor("states", states, torch.int64, (lanes,), dev)
    check_tensor("rows", rows, torch.int32, (None, GROUP), dev)
    check_tensor("ptrs", ptrs, torch.int32, (2, G), dev)
    if rows.shape[0] < T:
        raise ValueError(f"rows has {rows.shape[0]} steps, fewer than T={T}")
    return run(words_g, mant_g, states, rows, ptrs, T=T, lanes=lanes)


def decode_grouped_batched_cuda(
    words_g: torch.Tensor,
    mant_g: torch.Tensor,
    states: torch.Tensor,
    rows: torch.Tensor,
    ptrs: torch.Tensor,
    *,
    T: int,
    lanes: int,
):
    """Decode T scan steps of B same-geometry streams in one launch (kernel
    B2; see grouped.decode_grouped_batched for the arguments).

    words_g [B*G, capw] int32, mant_g [B*G, capm] int32 (shared caps),
    states [B, lanes] int64, rows [>= T, B, 128] int32, ptrs [2, B*G]
    int32 — all on one device. Returns (values [B, T*lanes] int32, states
    [B, lanes] int64, ptrs [2, B*G] int32)."""
    run = route("decode_grouped_batched_cuda", words_g.device, _decode_batched, decode_grouped_batched)
    G = n_groups(lanes)
    dev = words_g.device
    check_tensor("states", states, torch.int64, (None, lanes), dev)
    B = states.shape[0]
    if B < 1:
        raise ValueError("decode_grouped_batched_cuda needs at least one stream")
    check_tensor("words_g", words_g, torch.int32, (B * G, None), dev)
    check_tensor("mant_g", mant_g, torch.int32, (B * G, None), dev)
    check_tensor("rows", rows, torch.int32, (None, B, GROUP), dev)
    check_tensor("ptrs", ptrs, torch.int32, (2, B * G), dev)
    if rows.shape[0] < T:
        raise ValueError(f"rows has {rows.shape[0]} steps, fewer than T={T}")
    return run(words_g, mant_g, states, rows, ptrs, T=T, lanes=lanes)
