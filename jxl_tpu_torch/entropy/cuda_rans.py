"""Grouped rANS decode: CUDA kernel wrapper (kernel B1).

Replaces `jxl_tpu/entropy/pallas_rans.py:decode_grouped_pallas`, the Pallas
TPU decode scan. The kernel is `csrc/rans_dec.cu` (one 128-thread CTA per
128-lane group, states in registers, word/byte ranks from warp ballots);
its source note says what bounds it on an H100. The plain version is
`entropy/grouped.py:decode_grouped`, with the same arguments and outputs.

`decode_grouped_cuda` runs the kernel for CUDA tensors and the plain
version for CPU tensors, and raises on anything else. There is no
fallback: a CUDA call that cannot launch raises. `launches` counts kernel
launches.

The Pallas kernel's 128-aligned windows, read-ahead slack and VMEM budget
have no counterpart: the CUDA kernel reads at the stream pointer itself
and treats reads past a bucket's end as 0, like the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from jxl_tpu_torch.entropy.grouped import GROUP, decode_grouped, n_groups


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bit pattern."""
    x = x.to(torch.int64)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device: torch.device):
    """Raise ValueError unless t has the dtype, shape (None = any extent),
    device and contiguity the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


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
    """Decode T scan steps (see grouped.decode_grouped for the arguments).

    words_g [G, capw] int32, mant_g [G, capm] int32, states [lanes] int64,
    rows [>= T, 128] int32, ptrs [2, G] int32 — all on one device. Returns
    (values [T*lanes] int32, states [lanes] int64, ptrs [2, G] int32)."""
    G = n_groups(lanes)
    dev = words_g.device
    check_tensor("words_g", words_g, torch.int32, (G, None), dev)
    check_tensor("mant_g", mant_g, torch.int32, (G, None), dev)
    check_tensor("states", states, torch.int64, (lanes,), dev)
    check_tensor("rows", rows, torch.int32, (None, GROUP), dev)
    check_tensor("ptrs", ptrs, torch.int32, (2, G), dev)
    if rows.shape[0] < T:
        raise ValueError(f"rows has {rows.shape[0]} steps, fewer than T={T}")
    if dev.type == "cpu":
        return decode_grouped(words_g, mant_g, states, rows, ptrs, T=T, lanes=lanes)
    if dev.type != "cuda":
        raise ValueError(f"decode_grouped_cuda: unsupported device {dev}")

    from jxl_tpu_torch.cuda_build import load

    lib = load("rans_dec")
    fn = lib.jxl_rans_decode
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        st_in = u32_to_i32(states)
        values = torch.empty(T * lanes, dtype=torch.int32, device=dev)
        st_out = torch.empty(lanes, dtype=torch.int32, device=dev)
        ptr_out = torch.empty((2, G), dtype=torch.int32, device=dev)
        err = fn(
            words_g.data_ptr(), words_g.shape[1], mant_g.data_ptr(), mant_g.shape[1],
            rows.data_ptr(), T, st_in.data_ptr(), ptrs.data_ptr(), G,
            values.data_ptr(), st_out.data_ptr(), ptr_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rans_decode kernel launch failed: CUDA error {err}")
    decode_grouped_cuda.launches += 1
    return values, i32_to_u32(st_out), ptr_out


decode_grouped_cuda.launches = 0
