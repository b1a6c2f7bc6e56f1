"""Port parity: efforts 8 and 9 of jxl_tpu_torch (the two-pass
measured-rate model and the 128 / 256 merge rungs) against jxl_tpu, on
the CPU.

- `_bits_lut_grid` allclose (float32 log2 on both sides);
- the gather form of the measured rate (`acs._rate_bits_lut`) equals the
  reference's one-hot product form bit for bit;
- `search_acs` with a LUT at e8 and e9 on the same float inputs: the ACS
  maps equal (the differing count is printed);
- `encode_image` at e8 (128x192) and e9 (256x384, a smooth 256x256 region
  that takes the 256 merge beside 128-merged content), d = 1: bytes within
  0.5%, PSNR within 0.02 dB, both decode directions within 1 LSB, the
  differing ACS decisions printed;
- the grid encode at e8 byte-identical to `encode_image`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jxl_tpu.codec import encode as jenc
from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.codec.decode import decode_bytes as jax_decode
from jxl_tpu.core.xyb import srgb_to_xyb
from jxl_tpu.entropy.tokens import ALPHABET
from jxl_tpu.strategy import acs as jacs
from jxl_tpu.transforms.adaptive import qf_multiplier, quant_field

from jxl_tpu_torch.codec import decode as td
from jxl_tpu_torch.codec import encode as te
from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.entropy.tokens import tokenize, zigzag_map
from jxl_tpu_torch.strategy import acs as tacs

from tests.conftest import make_test_image
from tests.test_torch_encode import psnr, sections
from tests.torch_parity import np_


def smooth_image(h: int, w: int, busy_from: int, seed: int = 1) -> np.ndarray:
    """A smooth low-noise field (merges up to 256x256) with a striped busy
    band from column `busy_from` on (smaller transforms)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    lum = 0.45 + 0.2 * np.sin(xx / 90.0) * np.cos(yy / 70.0) + r.normal(0, 0.004, (h, w))
    lum[:, busy_from:] += 0.1 * (np.sin(yy[:, busy_from:] / 5.0) > 0)
    rgb = np.stack([lum * 0.9, lum, lum * 0.8], axis=-1)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def _counts(seed: int) -> np.ndarray:
    """[3, 63, A] seeded AC histograms with an unused tail and empty rows."""
    rng = np.random.default_rng(seed)
    c = (rng.pareto(1.3, (3, 63, ALPHABET)) * 30).astype(np.int64)
    c[:, :, 40:] = 0
    c[1, 50:] = 0
    return c


@pytest.mark.parametrize("seed", [0, 1])
def test_bits_lut_grid_allclose(seed):
    c = _counts(seed)
    ref = np.asarray(jenc._bits_lut_grid(jnp.asarray(c, jnp.int32)))
    got = np_(te._bits_lut_grid(torch.from_numpy(c)))
    print(f"LUT max |d| {np.abs(got - ref).max():.3g} bits")
    assert got.shape == (3, 8, 8, ALPHABET)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    assert (got[:, 0, 0] == 0).all()


@pytest.mark.parametrize("shape", [(3, 5, 7, 8, 8), (3, 2, 3, 2, 2, 8, 8)], ids=["sub8", "merged"])
def test_rate_bits_lut_gather_equals_onehot(shape):
    """The gather is the one-hot product's single nonzero term: the same
    float per coefficient, hence the same sums."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy((rng.laplace(0, 6, shape)).astype(np.int32))
    lut = te._bits_lut_grid(torch.from_numpy(_counts(2)))
    dims = tuple([0] + list(range(-len(shape) + 3, 0)))
    got = tacs._rate_bits_lut(q, lut, dims)
    sym = tokenize(zigzag_map(q))[0]
    oh = (sym[..., None] == torch.arange(ALPHABET)).to(torch.float32)
    full = lut.reshape((3,) + (1,) * (q.ndim - 3) + (8, 8, ALPHABET))
    onehot = torch.sum(torch.sum(oh * full, dim=-1), dim=dims)
    assert torch.equal(got, onehot)
    ref = jacs._rate_bits_lut(jnp.asarray(np_(q)), jnp.asarray(np_(lut)), axes=dims)
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("effort", [8, 9])
def test_search_acs_with_lut(effort):
    """search_acs on identical float inputs (the reference's XYB planes and
    quant field) and an identical LUT at 256x384: equal ACS maps, with the
    128 and 256 rungs in play at e9."""
    img = smooth_image(256, 384, busy_from=256)
    planes = np.asarray(srgb_to_xyb(jnp.asarray(img.astype(np.float32) / 255.0)))
    planes = np.stack([planes[..., 0], planes[..., 1], planes[..., 2] - planes[..., 1]]).astype(np.float32)
    blocks = planes.reshape(3, 32, 8, 48, 8).transpose(0, 1, 3, 2, 4)
    qf_mul = np.array(qf_multiplier(quant_field(jnp.asarray(planes[1]))))
    lut = np_(te._bits_lut_grid(torch.from_numpy(_counts(4))))
    ref_acs, _raw, _st = jacs.search_acs(
        jnp.asarray(blocks), jnp.asarray(planes), 1.0, effort=effort, hook_a=False, hook_b=False,
        qf_mul=jnp.asarray(qf_mul), bit_lut=jnp.asarray(lut),
    )
    acs, _raw_t, _st_t = tacs.search_acs(
        torch.from_numpy(np.ascontiguousarray(blocks)), torch.from_numpy(planes), 1.0, effort=effort,
        qf_mul=torch.from_numpy(qf_mul), bit_lut=torch.from_numpy(lut),
    )
    ref_acs = np.asarray(ref_acs)
    diff = int((np_(acs) != ref_acs).sum())
    ids = sorted(set(ref_acs.reshape(-1).tolist()))
    print(f"e{effort}: ACS decisions differing {diff}/{ref_acs.size}; strategy ids {ids}")
    assert diff == 0
    assert (tacs.ACS_DCT256X256 in ids) == (effort == 9)


CASES = [(8, (128, 192), "photo"), (9, (256, 384), "smooth")]


@pytest.mark.parametrize("effort,shape,kind", CASES, ids=["e8", "e9"])
def test_encode_effort_bars(effort, shape, kind):
    h, w = shape
    img = make_test_image(h, w, seed=11) if kind == "photo" else smooth_image(h, w, busy_from=256)
    ref = jenc.encode_image(img, JaxConfig(distance=1.0, effort=effort))
    got = te.encode_image(img, CodecConfig(distance=1.0, effort=effort), device="cpu")
    q_ref = psnr(img, np.asarray(jax_decode(ref)))
    q_got = psnr(img, np.asarray(jax_decode(got)))
    rel = len(got) / len(ref) - 1.0
    acs_ref, acs_got = sections(ref)[1], sections(got)[1]
    print(
        f"e{effort} {h}x{w}: bytes {len(got)} vs {len(ref)} ({rel:+.4%}), PSNR {q_got:.4f} vs {q_ref:.4f} dB, "
        f"ACS decisions differing {int((acs_ref != acs_got).sum())}/{acs_ref.size}, "
        f"strategy ids {sorted(set(acs_got.reshape(-1).tolist()))}"
    )
    assert abs(rel) <= 0.005
    assert abs(q_got - q_ref) <= 0.02
    for data in (ref, got):
        a = np.asarray(jax_decode(data)).astype(np.int32)
        b = td.decode_bytes(data, device="cpu").astype(np.int32)
        assert np.abs(a - b).max() <= 1
    if effort == 9:
        assert tacs.ACS_DCT256X256 in set(acs_got.reshape(-1).tolist())


def test_grid_e8_matches_encode_image():
    img = make_test_image(64, 96, seed=6)
    ds = [0.7, 2.5]
    grid = te.encode_image_grid(img, CodecConfig(effort=8), ds, device="cpu")
    for d, data in zip(ds, grid):
        assert data == te.encode_image(img, CodecConfig(distance=d, effort=8), device="cpu")
    fin = te.encode_images_batched_async([img, img[::-1].copy()], CodecConfig(effort=9), [1.0, 3.0], device="cpu")
    out = fin()
    assert out[1] == te.encode_image(img[::-1].copy(), CodecConfig(distance=3.0, effort=9), device="cpu")
