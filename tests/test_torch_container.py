"""Port parity: the JXT container and token layouts of jxl_tpu_torch against
jxl_tpu (both numpy; bit-exact), and the hardened reader's behaviour on
malformed input (the probes of tests/test_fuzz.py, run against the port)."""

import struct
import time

import numpy as np
import pytest

from jxl_tpu.codec import container as jc
from jxl_tpu.codec import layout as jl
from jxl_tpu.codec.config import CodecConfig
from jxl_tpu.codec.encode import encode_image

from jxl_tpu_torch.codec import container as tc
from jxl_tpu_torch.codec import layout as tl
from jxl_tpu_torch.codec.decode import decode_bytes

from tests.conftest import make_test_image
from tests.test_fuzz import _patch_header, _patch_stream_fields


@pytest.fixture(scope="module")
def containers():
    """JAX-written containers: lossy VarDCT at d=1 / e7 and d=2 / e3, and
    d=0 lossless (modular)."""
    return {
        "d1e7": encode_image(make_test_image(48, 64, seed=3), CodecConfig(distance=1.0, effort=7)),
        "d2e3": encode_image(make_test_image(48, 64, seed=3), CodecConfig(distance=2.0, effort=3)),
        "lossless": encode_image(make_test_image(24, 40, seed=4), CodecConfig(distance=0.0)),
    }


@pytest.mark.parametrize("name", ["d1e7", "d2e3", "lossless"])
def test_read_write_identical_bytes(containers, name):
    data = containers[name]
    s = tc.read_container(data)
    assert tc.write_container(s) == data
    r = jc.read_container(data)
    assert s.header == tc.JxtHeader(**vars(r.header))
    for f in ("freq", "states", "wcounts", "mcounts", "tables", "cmap"):
        np.testing.assert_array_equal(getattr(s, f), getattr(r, f))
    assert (s.stream_words, s.mant_bytes, s.acs_extra) == (r.stream_words, r.mant_bytes, r.acs_extra)
    assert s.header.decode_params == r.header.decode_params


def _assert_layout_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
        else:
            assert a[k] == b[k], k


SIZES = [(1, 1), (8, 8), (9, 17), (48, 64), (100, 300), (128, 160), (257, 129)]


@pytest.mark.parametrize("h,w", SIZES)
def test_layout_dicts_equal(h, w):
    _assert_layout_equal(tl.token_layout(h, w), jl.token_layout(h, w))
    for lanes in (128, 256, 512):
        _assert_layout_equal(tl.padded_layout(h, w, lanes), jl.padded_layout(h, w, lanes))
        _assert_layout_equal(tl.lossless_layout(h, w, lanes), jl.lossless_layout(h, w, lanes))
    lossy, lossless = tl.layout_counts(h, w, False), tl.layout_counts(h, w, True)
    assert lossy == (jl.token_layout(h, w)["n_tokens"], jl.token_layout(h, w)["n_ctx"])
    ll = jl.lossless_layout(h, w, 128)
    assert lossless == (ll["n_tokens"], ll["n_ctx"])


def test_format_constants_equal():
    assert (tc.MAGIC, tc.VERSION) == (jc.MAGIC, jc.VERSION)
    assert (tc.MAX_DIM, tc.MAX_PIXELS, tc.MAX_LANES) == (jc.MAX_DIM, jc.MAX_PIXELS, jc.MAX_LANES)
    for name in ("NNZ_Q", "NNZ_EDGES", "CTX_ACS", "CTX_QF", "CTX_CFL", "CTX_NNZ",
                 "CTX_AC_BASE", "N_CTX", "CFL_TILE", "LL_Q", "LL_EDGES", "N_BANDS"):
        assert getattr(tl, name) == getattr(jl, name), name
    np.testing.assert_array_equal(tl.ac_band_table(), jl.ac_band_table())


def test_truncations_raise_cleanly(containers):
    data = containers["d2e3"]
    r = np.random.default_rng(11)
    cuts = sorted(set(int(x) for x in r.integers(0, len(data), 60)))
    for cut in cuts + [0, 1, 4, 8, len(data) - 1]:
        with pytest.raises(ValueError, match="malformed JXT container"):
            tc.read_container(data[:cut])


def test_byte_flips_never_crash(containers):
    """Payload flips decode (garbage pixels are fine) or raise ValueError."""
    data = containers["d2e3"]
    r = np.random.default_rng(12)
    decoded = 0
    for _ in range(25):
        pos = int(r.integers(0, len(data)))
        mut = bytearray(data)
        mut[pos] ^= 1 << int(r.integers(0, 8))
        try:
            out = decode_bytes(bytes(mut), device="cpu")
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.shape[2] == 3
        decoded += 1
    assert decoded > 0


def test_adversarial_header_fields(containers):
    data = containers["d2e3"]
    for h, w in [(0, 64), (1 << 21, 64), (1 << 14, 1 << 14), (48, 0)]:
        with pytest.raises(ValueError):
            tc.read_container(_patch_header(data, height=h, width=w))
    for kw in [
        dict(n_tokens=0), dict(n_tokens=0xFFFFFFFF), dict(n_ctx=1), dict(n_ctx=0xFFFF),
        dict(alphabet=255), dict(lanes=0), dict(lanes=130), dict(lanes=0xFF80),
    ]:
        with pytest.raises(ValueError):
            tc.read_container(_patch_stream_fields(data, **kw))
    with pytest.raises(ValueError):
        tc.read_container(_patch_header(data, name_len=0xFFFF))
    with pytest.raises(ValueError):
        tc.read_container(_patch_header(data, version=7))
    flags = struct.unpack_from("<BIIfBBBH", data, 4)[6]
    with pytest.raises(ValueError):
        tc.read_container(_patch_header(data, flags=flags ^ 2))


def test_bad_magic_and_empty():
    for blob in [b"", b"JX", b"NOPE" + b"\0" * 64, tc.MAGIC]:
        with pytest.raises(ValueError):
            tc.read_container(blob)
    with pytest.raises(ValueError):
        tc.read_container_header(b"JXT1\x08")


@pytest.mark.parametrize("lossless", [False, True])
def test_oversized_header_rejected_quickly(containers, lossless):
    """A forged header at the 64 MP cap with token counts consistent with
    its geometry: the reader validates it in closed form, so parsing (and
    rejecting a truncated copy) is immediate, with no 8192x8192 layout
    tables built."""
    data = containers["lossless" if lossless else "d2e3"]
    n_tokens, n_ctx = tl.layout_counts(8192, 8192, lossless)
    forged = _patch_stream_fields(
        _patch_header(data, height=8192, width=8192), n_tokens=n_tokens, n_ctx=n_ctx
    )
    t = time.perf_counter()
    with pytest.raises(ValueError, match="malformed JXT container"):
        tc.read_container(forged[: len(forged) // 2])
    s = tc.read_container(forged)  # self-consistent sections: parses
    assert time.perf_counter() - t < 0.5
    assert (s.header.height, s.header.n_tokens) == (8192, n_tokens)
    assert tl.token_layout.cache_info().currsize <= 16


def test_forged_stream_counts(containers):
    s = tc.read_container(containers["d2e3"])
    s.wcounts = s.wcounts.copy()
    s.wcounts[0] += 7
    with pytest.raises(ValueError):
        tc.read_container(tc.write_container(s))
