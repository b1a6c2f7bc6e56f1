"""The benchmark's yardstick, frozen so that no change to the program moves it.

- the published HBM3 bandwidth of one NVIDIA H100 SXM (data sheet, at its
  700 W limit);
- the bytes the rANS scan kernels must move, from the stream's shapes
  (copies of `jxl_tpu_torch/entropy/kernel_bounds.py:encode_bytes` and
  `decode_bytes`);
- device busy time as the union of the CUDA kernel intervals of a
  `torch.profiler` trace (copies of `headline.kernel_intervals` and
  `busy_ms`);
- a percentile over all requests;
- the card's name and power limit from `nvidia-smi` (a copy of
  `headline.smi_line` / `card_info`).
"""

from __future__ import annotations

import subprocess

PEAK_BW = 3.35e12  # bytes/s, HBM3
WORD = 4  # every element the rANS kernels read or write is an int32
GROUP = 128  # lanes per rANS group


def decode_bytes(T: int, lanes: int, n_words: int, n_mbytes: int, B: int = 1) -> int:
    """Bytes a decode launch over B streams must move: reads rows [T, B,
    128], the n_words words and n_mbytes mantissa bytes it consumes, states
    [B, lanes] and pointers [2, B*G]; writes values [B, T*lanes], states
    and pointers."""
    G = lanes // GROUP
    reads = T * B * 128 + n_words + n_mbytes + B * lanes + 2 * B * G
    writes = B * T * lanes + B * lanes + 2 * B * G
    return WORD * (reads + writes)


def encode_bytes(T: int, lanes: int, n_words: int, n_mbytes: int) -> int:
    """Bytes an encode launch must move: reads tokens and mantissas [T *
    lanes] and rows [T, 128]; writes the n_words words and n_mbytes
    mantissa bytes it emits, states [lanes] and counts [2, G]."""
    G = lanes // GROUP
    reads = 2 * T * lanes + T * 128
    writes = n_words + n_mbytes + lanes + 2 * G
    return WORD * (reads + writes)


def union_ns(intervals) -> int:
    """Nanoseconds covered by the union of (start_ns, end_ns) intervals."""
    total, covered = 0, None
    for s, e in sorted(intervals):
        if covered is not None:
            s = max(s, covered)
        if e > s:
            total += e - s
            covered = e
    return total


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted, disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [tuple(x) for x in out]


def is_kernel(name: str) -> bool:
    """Whether a device event is a kernel: CUPTI names memory copies and
    sets "Memcpy ..." and "Memset ..."."""
    return not name.startswith(("Memcpy", "Memset"))


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def card_info(dev) -> dict:
    """The CUDA card's name and power limit (W) as `nvidia-smi` reports them,
    the card picked by its UUID and held to torch's name for it."""
    import torch

    uuid = torch.cuda.get_device_properties(dev).uuid
    line = subprocess.run(
        ["nvidia-smi", "-i", f"GPU-{uuid}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    name, limit = (v.strip() for v in line.rsplit(",", 1))
    if name != torch.cuda.get_device_name(dev):
        raise RuntimeError(f"nvidia-smi reports {line!r} for GPU-{uuid}, torch {torch.cuda.get_device_name(dev)!r}")
    return {"name": name, "power_limit_w": float(limit.split()[0])}
