"""Least times of the rANS scan kernels (B1, B2, B3) on an H100.

Two bounds for each launch, both computed from its shapes and the stream
lengths of its data:

- the roofline bound: the bytes the function must move (each input read
  once, each output written once, every element an int32 as the kernels
  take them) over the card's memory rate, 3.35 TB/s. Only the words and
  mantissa bytes the data really holds count, not the buckets' caps.
- the chain bound: the T steps of a group are a chain, each step needing
  the previous one's state, so a launch takes at least T times the latency
  of the operations one step must do in order, whatever runs beside it:
    decode: the symbol lookup for the slot (one shared-memory load), the
      multiply-add, the renormalise test, its rank (a ballot and a
      popcount), the read of the ranked word and the merge into the state;
    encode: the renormalise test, the shift it selects, the quotient from
      the reciprocal product, the remainder and the new state.
  Those latencies are measured on the card, not assumed:
  `measure_chain_cycles` runs each chain alone in one warp
  (`csrc/chain_probe.cu`) and returns SM cycles per link; divided by the
  SM clock sampled beside the measurement.

`cycles_per_step` turns a measured time back into SM cycles per step.
`chip_smoke.py` prints all of these beside each kernel's time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
WORD = 4  # every element the kernels read or write is an int32

# the chains of csrc/chain_probe.cu, in its output order
CHAINS = ("smem_load", "imad", "select", "vote", "decode_step", "encode_step")
PROBE_LINKS = 4096


def decode_bytes(T: int, lanes: int, n_words: int, n_mbytes: int, B: int = 1) -> int:
    """Bytes a decode launch over B streams must move: reads rows [T, B,
    128], the n_words words and n_mbytes mantissa bytes it consumes, states
    [B, lanes] and pointers [2, B*G]; writes values [B, T*lanes], states
    and pointers."""
    G = lanes // 128
    reads = T * B * 128 + n_words + n_mbytes + B * lanes + 2 * B * G
    writes = B * T * lanes + B * lanes + 2 * B * G
    return WORD * (reads + writes)


def encode_bytes(T: int, lanes: int, n_words: int, n_mbytes: int) -> int:
    """Bytes an encode launch must move: reads tokens and mantissas [T *
    lanes] and rows [T, 128]; writes the n_words words and n_mbytes
    mantissa bytes it emits, states [lanes] and counts [2, G]."""
    G = lanes // 128
    reads = 2 * T * lanes + T * 128
    writes = n_words + n_mbytes + lanes + 2 * G
    return WORD * (reads + writes)


def roofline_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def chain_cycles(totals, links: int = PROBE_LINKS) -> dict:
    """The probe's cycle totals (one per chain of CHAINS, each `links`
    links long) as SM cycles per link."""
    if len(totals) != len(CHAINS):
        raise ValueError(f"{len(totals)} totals for {len(CHAINS)} chains")
    return {name: float(c) / links for name, c in zip(CHAINS, totals)}


def chain_bound_ms(T: int, step_cycles: float, clock_mhz: float) -> float:
    """T chained steps of `step_cycles` SM cycles each at `clock_mhz`."""
    return T * step_cycles / (clock_mhz * 1e3)


def cycles_per_step(ms: float, T: int, clock_mhz: float) -> float:
    """A measured time over T steps in SM cycles per step."""
    return ms * clock_mhz * 1e3 / T


def measure_chain_cycles(device, links: int = PROBE_LINKS) -> dict:
    """SM cycles per link of each chain of `csrc/chain_probe.cu` on the CUDA
    `device`: one warp, `links` links a chain, the second of two launches
    (the first warms the instruction cache)."""
    import ctypes

    import torch

    from jxl_tpu_torch.cuda_build import load

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_chain_cycles needs a CUDA device, got {dev}")
    fn = load("chain_probe").jxl_chain_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        cycles = torch.zeros(len(CHAINS), dtype=torch.int64, device=dev)
        sink = torch.zeros(32, dtype=torch.int32, device=dev)
        for _ in range(2):
            err = fn(links, 0x9E3779B9, cycles.data_ptr(), sink.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"chain_probe kernel launch failed: CUDA error {err}")
        totals = cycles.tolist()
    return chain_cycles(totals, links)
