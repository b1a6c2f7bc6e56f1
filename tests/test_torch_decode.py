"""Port parity: jxl_tpu_torch decodes containers that jxl_tpu wrote.

On `conftest.make_test_image` (128x160) at d in {1, 3}, e7: the decoded
value stream is bit-exact against the reference's decoder (its XLA rANS
scan, run phase by phase as `_decode_packed_core` runs it), and pixels are
within 1 LSB of `jxl_tpu.codec.decode.decode_bytes` (float order in the
IDCT, EPF and XYB stages differs between the frameworks).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jxl_tpu.codec import decode as jd
from jxl_tpu.codec.config import CodecConfig
from jxl_tpu.codec.container import read_container
from jxl_tpu.codec.encode import ac_step_ctx as jax_ac_step_ctx
from jxl_tpu.codec.encode import encode_image
from jxl_tpu.codec.layout import padded_layout
from jxl_tpu.entropy.grouped import GROUP, decode_grouped, kernel_rows
from jxl_tpu.entropy.pallas_rans import MANT_SLACK, WORD_SLACK

from jxl_tpu_torch.codec import decode as td
from jxl_tpu_torch.codec.container import read_container as port_read

from tests.conftest import make_test_image

DISTANCES = [1.0, 3.0]


def jax_values(data: bytes) -> np.ndarray:
    """The reference decoder's value stream [n_tokens] (K-padding removed):
    both XLA scan phases joined by the carry, phase B's contexts from the
    decoded nnz map."""
    s = read_container(data)
    h = s.header
    lay = padded_layout(h.height, h.width, h.lanes)
    G = h.lanes // GROUP
    wc, mc = s.wcounts.astype(np.int64), s.mcounts.astype(np.int64)
    wg = np.zeros((G, int(wc.max()) + WORD_SLACK), np.uint32)
    mg = np.zeros((G, int(mc.max()) + MANT_SLACK), np.uint32)
    words = np.frombuffer(s.stream_words, "<u2")
    mant = np.frombuffer(s.mant_bytes, np.uint8)
    wb, mb = np.concatenate([[0], np.cumsum(wc)]), np.concatenate([[0], np.cumsum(mc)])
    for g in range(G):
        wg[g, : wc[g]] = words[wb[g] : wb[g + 1]]
        mg[g, : mc[g]] = mant[mb[g] : mb[g + 1]]
    freq = jnp.asarray(s.freq.astype(np.uint32))
    cum = jnp.concatenate([jnp.zeros((freq.shape[0], 1), jnp.uint32), jnp.cumsum(freq, axis=1)[:, :-1]], axis=1)
    t_a, T = lay["t_a"], lay["T"]
    va, st, gp, bp = decode_grouped(
        jnp.asarray(wg), jnp.asarray(mg), jnp.asarray(s.states),
        kernel_rows(jnp.asarray(lay["step_ctx"][:t_a]), freq, cum),
        T=t_a, lanes=h.lanes, return_carry=True,
    )
    _q, q_sorted = jd._nnz_map_from_padded(va, h.decode_params, lay)
    vb = decode_grouped(
        jnp.asarray(wg), jnp.asarray(mg), st,
        kernel_rows(jax_ac_step_ctx(lay, q_sorted), freq, cum),
        T=T - t_a, lanes=h.lanes, gptr0=gp, bptr0=bp,
    )
    vp = np.concatenate([np.asarray(va), np.asarray(vb)])
    return np.concatenate([vp[dst : dst + n] for _c, dst, n, _p in lay["spans"]])


@pytest.fixture(scope="module")
def cases():
    img = make_test_image()
    out = {}
    for d in DISTANCES:
        data = encode_image(img, CodecConfig(distance=d, effort=7))
        out[d] = (data, np.asarray(jd.decode_bytes(data)))
    return img, out


@pytest.mark.parametrize("d", DISTANCES)
def test_value_stream_bit_exact(cases, d):
    data, _ = cases[1][d]
    port = td.decode_values(port_read(data), "cpu")
    np.testing.assert_array_equal(port.numpy().astype(np.int64), jax_values(data).astype(np.int64))


@pytest.mark.parametrize("d", DISTANCES)
def test_pixels_within_one_lsb(cases, d):
    img, byd = cases
    data, ref = byd[d]
    out = td.decode_bytes(data, device="cpu")
    assert out.shape == ref.shape and out.dtype == np.uint8
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    print(f"d={d}: pixels max |d| {diff.max()} LSB, {np.mean(diff > 0):.4%} differ")
    assert diff.max() <= 1


@pytest.mark.parametrize("d", DISTANCES)
def test_decode_device_form(cases, d):
    data, _ = cases[1][d]
    t = td.decode_bytes_device(data, device="cpu")
    assert isinstance(t, torch.Tensor) and t.dtype == torch.uint8 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), td.decode_bytes(data, device="cpu"))


def test_merged_ladder_reconstruction():
    """The decoder's dense n x n reassembly for every merge rung (the
    128/256 rungs too, which only e8/e9 streams use) against the
    reference's, on the same dequantised storage."""
    from jxl_tpu.codec.decode import _overlay_merged as j_overlay
    from jxl_tpu.strategy.acs import MERGE_LADDER

    rng = np.random.default_rng(8)
    nby, nbx = 32, 36
    storage = rng.normal(0, 0.05, (3, nby, nbx, 8, 8)).astype(np.float32)
    dc = rng.normal(0, 0.3, (3, nby, nbx)).astype(np.float32)
    pix = rng.normal(0, 0.5, (3, nby * 8, nbx * 8)).astype(np.float32)
    for n, sid, _e in MERGE_LADDER:
        k = n // 8
        acs = np.zeros((nby, nbx), np.int64)
        acs[:k, :k] = sid  # one group of this size at the origin
        ref = np.asarray(j_overlay(jnp.asarray(pix), jnp.asarray(storage), jnp.asarray(dc), jnp.asarray(acs), n, sid))
        got = td._overlay_merged(
            torch.from_numpy(pix), torch.from_numpy(storage), torch.from_numpy(dc), torch.from_numpy(acs), n, sid
        ).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5, err_msg=f"{n}x{n}")
