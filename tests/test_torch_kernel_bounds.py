"""The rANS kernels' least times (jxl_tpu_torch/entropy/kernel_bounds.py):
byte counts and chain-bound arithmetic pinned at the bench shape and two
other shapes. Pure arithmetic, no device."""

import re

import pytest

from jxl_tpu_torch.cuda_build import CSRC
from jxl_tpu_torch.entropy.kernel_bounds import (
    CHAINS,
    HBM_BYTES_PER_S,
    chain_bound_ms,
    chain_cycles,
    cycles_per_step,
    decode_bytes,
    encode_bytes,
    roofline_ms,
)

# the bench image at d=1, e7 (512x768): lanes 256, T 4731; the stream holds
# 35,730 words and 2,213 mantissa bytes over its two groups
BENCH = dict(T=4731, lanes=256, n_words=35730, n_mbytes=2213)


def test_decode_bytes_bench_shape():
    # rows 4731 x 128, the consumed words and bytes, states 256 and
    # pointers 2 x 2 in; values 4731 x 256, states and pointers out
    reads = 4731 * 128 + 35730 + 2213 + 256 + 4
    writes = 4731 * 256 + 256 + 4
    assert decode_bytes(**BENCH) == 4 * (reads + writes) == 7_420_668
    assert 7.4e6 < decode_bytes(**BENCH) < 7.45e6


def test_encode_bytes_bench_shape():
    # tokens and mantissas 4731 x 256, rows 4731 x 128 in; the emitted
    # words and bytes, states 256 and counts 2 x 2 out
    reads = 2 * 4731 * 256 + 4731 * 128
    writes = 35730 + 2213 + 256 + 4
    assert encode_bytes(**BENCH) == 4 * (reads + writes) == 12_264_172
    assert 12.25e6 < encode_bytes(**BENCH) < 12.3e6


@pytest.mark.parametrize(
    "T,lanes,n_words,n_mbytes,B,dec,enc",
    [
        # the uniform-noise d = 0 stream (phase 3c): 1,007,622 mantissa bytes
        (4680, 256, 0, 1007622, 1, 11_221_048, 16_012_328),
        # a batch of 64 streams of 8 groups (the widest B2 case on the card)
        (48, 1024, 5000, 700, 64, 14_711_056, 444_752),
    ],
)
def test_bytes_other_shapes(T, lanes, n_words, n_mbytes, B, dec, enc):
    G = lanes // 128
    want_dec = 4 * (T * B * 128 + n_words + n_mbytes + 2 * B * lanes + 4 * B * G + B * T * lanes)
    assert decode_bytes(T, lanes, n_words, n_mbytes, B=B) == want_dec == dec
    assert encode_bytes(T, lanes, n_words, n_mbytes) == 4 * (2 * T * lanes + T * 128 + n_words + n_mbytes + lanes + 2 * G) == enc


def test_batched_decode_bytes_scale_with_streams():
    one = decode_bytes(**BENCH)
    assert decode_bytes(4731, 256, 32 * 35730, 32 * 2213, B=32) == 32 * one == 237_461_376


# cycle totals of the probe's six chains, 4096 links each, in the form
# `measure_chain_cycles` receives them (example values)
TOTALS = (119808, 16384, 53248, 204800, 532480, 196608)


def test_chain_cycles_per_link():
    c = chain_cycles(TOTALS)
    assert tuple(c) == CHAINS == ("smem_load", "imad", "select", "vote", "decode_step", "encode_step")
    assert c["smem_load"] == 29.25 and c["decode_step"] == 130.0 and c["encode_step"] == 48.0
    assert chain_cycles([t // 2 for t in TOTALS], links=2048) == c
    with pytest.raises(ValueError):
        chain_cycles(TOTALS[:5])


def test_chain_and_roofline_bounds_at_bench_shape():
    # 4731 steps x 130 cycles at 1980 MHz; 4731 x 48 for the encode
    c = chain_cycles(TOTALS)
    assert chain_bound_ms(4731, c["decode_step"], 1980.0) == pytest.approx(4731 * 130 / 1.98e6, rel=1e-12)
    assert chain_bound_ms(4731, c["decode_step"], 1980.0) == pytest.approx(0.31062121, rel=1e-6)
    assert chain_bound_ms(4731, c["encode_step"], 1980.0) == pytest.approx(0.11469091, rel=1e-6)
    assert roofline_ms(7_420_668) == pytest.approx(7_420_668 / HBM_BYTES_PER_S * 1e3, rel=1e-12)
    assert roofline_ms(7_420_668) == pytest.approx(2.2151e-3, rel=1e-4)


def test_cycles_per_step_inverts_the_chain_bound():
    for T, mhz, step in ((4731, 1980.0, 130.0), (4680, 1755.0, 48.0), (195, 1410.0, 97.5)):
        ms = chain_bound_ms(T, step, mhz)
        assert cycles_per_step(ms, T, mhz) == pytest.approx(step, rel=1e-12)
    # a 2.618 ms decode of 4731 steps at 1980 MHz is ~1096 cycles a step
    assert cycles_per_step(2.618, 4731, 1980.0) == pytest.approx(1095.6, abs=0.1)


def _c_function(src: str, head: str) -> str:
    """The body of the C function declared by `head` in `src`, comments and
    blanks dropped."""
    start = src.index(head)
    body = src[src.index("{", start) : src.index("\n}\n", start) + 2]
    return re.sub(r"\s+", "", re.sub(r"//[^\n]*", "", body))


def test_chain_probe_divides_as_the_encode_kernel():
    """The probe's encode chain uses the encode kernel's reciprocal as it
    stands in rans_enc.cu, so its latency is that of the kernel's code."""
    enc = (CSRC / "rans_enc.cu").read_text()
    probe = (CSRC / "chain_probe.cu").read_text()
    assert _c_function(probe, "uint2 reciprocal(") == _c_function(enc, "uint2 reciprocal(")
    assert "__umulhi(x1, o.w)" in probe and "__umulhi(x1, o.mf[k].y)" in enc


def _reciprocal(f: int) -> tuple[int, int]:
    """rans_enc.cu's M(f) = floor(2^64 / f) + 1 from two 32-bit divisions,
    as (hi, lo) 32-bit halves: a transcription of its `reciprocal()`, so
    this pins the arithmetic, not the compiled kernel (the card tests hold
    B3 bit-exact for every f in [1, 4096])."""
    a = 0xFFFFFFFF // f
    r = 0xFFFFFFFF - a * f  # 2^32 - 1 = a f + r
    if r + 1 == f:
        a, r = a + 1, 0
    else:
        r += 1  # now 2^32 = a f + r
    m = ((a << 32) | (r * a + (r * r) // f)) + 1
    assert m == (1 << 64) // f + 1
    return m >> 32, m & 0xFFFFFFFF


def test_encode_reciprocal_divides_exactly():
    """The encode kernel's division: q = (x * hi + umulhi(x, lo)) >> 32 equals
    x // f for every 32-bit x (random, edges, multiples of f and their
    neighbours) and every frequency f in [2, 4096]; f = 1 takes q = x."""
    import numpy as np

    rng = np.random.default_rng(0)
    base = np.concatenate([rng.integers(0, 1 << 32, 256, dtype=np.uint64), np.array([0, 1, (1 << 32) - 2, (1 << 32) - 1], np.uint64)])
    for f in range(2, 4097):
        hi, lo = _reciprocal(f)
        k = rng.integers(0, (1 << 32) // f, 64, dtype=np.uint64) * np.uint64(f)
        x = np.concatenate([base, k, k + np.uint64(f - 1), np.maximum(k, np.uint64(1)) - np.uint64(1)])
        x = x[x < (1 << 32)]
        q = (x * np.uint64(hi) + ((x * np.uint64(lo)) >> np.uint64(32))) >> np.uint64(32)
        np.testing.assert_array_equal(q, x // np.uint64(f), err_msg=f"f={f}")
