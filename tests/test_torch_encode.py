"""Port parity: jxl_tpu_torch's encoder against jxl_tpu's on the same image.

Bars (float decisions — ACS argmins, RDO and map-coding choices, the EPF
and nnz-conditioning margins — may flip on near-ties under another float
order, so containers need not be byte-identical):
- containers decode both ways (port -> reference decoder, reference ->
  port decoder) within 1 LSB of the other decoder;
- container bytes within 0.5% and PSNR within 0.02 dB of jxl_tpu's;
- the decoded value streams (tokens_from_rgb's integer output) are
  compared section by section: where the decisions (coding modes, ACS
  map, nnz decision, EPF bit) agree, every map / CfL / DC section must be
  identical and at most 0.1% of the AC values may differ (single
  coefficients whose RDO choice sits on a tie).
The test output reports the ACS flip count and whether the EPF and nnz
decisions agree.
"""

import numpy as np
import pytest

from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.codec.decode import decode_bytes as jax_decode
from jxl_tpu.codec.encode import encode_image as jax_encode

from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.container import read_container
from jxl_tpu_torch.codec.decode import decode_bytes, decode_values, unpredict_lcol
from jxl_tpu_torch.codec.encode import encode_image
from jxl_tpu_torch.codec.layout import NNZ_Q, token_layout
from jxl_tpu_torch.entropy.tokens import zigzag_unmap
from jxl_tpu_torch.strategy.acs import N_STRATEGIES

from tests.conftest import make_test_image


def psnr(a, b) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(10 * np.log10(255.0**2 / np.mean(d * d)))


def sections(data: bytes):
    """Decoded value stream of a container, split into its sections, plus
    the decoded ACS map, the nnz-bucket map and the decode params."""
    s = read_container(data)
    h = s.header
    lay = token_layout(h.height, h.width)
    v = decode_values(s, "cpu")
    names = ("acs", "qf", "cfl", "nnz", "dc", "ac")
    sizes = [lay[k] for k in ("n_acs", "n_qf", "n_cfl", "n_nnz", "n_dc", "n_ac")]
    parts, o = {}, 0
    for name, n in zip(names, sizes):
        parts[name] = v[o : o + n]
        o += n
    p = h.decode_params

    def field(x, levels, bit):
        x = x.reshape(-1, lay["nby"], lay["nbx"]).long()
        if (p >> bit) & 1:
            x = np.stack([unpredict_lcol(zigzag_unmap(c)).numpy() for c in x])
        return np.clip(np.asarray(x), 0, levels - 1)

    return parts, field(parts["acs"], N_STRATEGIES, 3)[0], field(parts["nnz"], NNZ_Q, 5), h


@pytest.fixture(scope="module")
def pair():
    img = make_test_image()
    jax_data = jax_encode(img, JaxConfig(distance=1.0, effort=7))
    port_data = encode_image(img, CodecConfig(distance=1.0, effort=7), device="cpu")
    return img, jax_data, port_data


def test_containers_decode_both_ways(pair):
    _img, jax_data, port_data = pair
    for data in (jax_data, port_data):
        a = np.asarray(jax_decode(data)).astype(np.int32)
        b = decode_bytes(data, device="cpu").astype(np.int32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1


def test_bytes_and_psnr_within_bars(pair):
    img, jax_data, port_data = pair
    q_jax = psnr(img, np.asarray(jax_decode(jax_data)))
    q_port = psnr(img, np.asarray(jax_decode(port_data)))
    rel = len(port_data) / len(jax_data) - 1.0
    print(f"bytes {len(port_data)} vs {len(jax_data)} ({rel:+.4%}); PSNR {q_port:.4f} vs {q_jax:.4f} dB")
    assert abs(rel) <= 0.005
    assert abs(q_port - q_jax) <= 0.02


def test_decisions_and_value_streams(pair):
    _img, jax_data, port_data = pair
    pj, acs_j, nnz_j, hj = sections(jax_data)
    pt, acs_t, nnz_t, ht = sections(port_data)
    acs_flips = int((acs_j != acs_t).sum())
    epf_agree = hj.epf == ht.epf
    nnz_agree = bool((nnz_j != 0).any() == (nnz_t != 0).any())
    diffs = {k: int((pj[k] != pt[k]).sum()) for k in pj}
    print(
        f"ACS flips {acs_flips}/{acs_j.size}; EPF decision agrees: {epf_agree}; "
        f"nnz decision agrees: {nnz_agree}; mode field {hj.mode_field} vs {ht.mode_field}; "
        f"differing values per section: {diffs}"
    )
    if acs_flips == 0 and epf_agree and nnz_agree and hj.flags == ht.flags:
        for k in ("acs", "qf", "cfl", "nnz", "dc"):
            assert diffs[k] == 0, k
        assert diffs["ac"] <= 1e-3 * pj["ac"].numel()


@pytest.mark.parametrize("effort", [1, 4, 6])
def test_lower_efforts_match(effort):
    """The effort gates below e7 (no CfL / fixed DC predictor at e1, the
    dead-zone quantiser below e5, fewer merge rungs) against the reference."""
    img = make_test_image(64, 96, seed=5)
    jax_data = jax_encode(img, JaxConfig(distance=2.0, effort=effort))
    port_data = encode_image(img, CodecConfig(distance=2.0, effort=effort), device="cpu")
    assert abs(len(port_data) / len(jax_data) - 1.0) <= 0.005
    ref = np.asarray(jax_decode(jax_data))
    assert abs(psnr(img, np.asarray(jax_decode(port_data))) - psnr(img, ref)) <= 0.02
    assert np.abs(decode_bytes(jax_data, device="cpu").astype(np.int32) - ref).max() <= 1
