"""Port parity: the thesis's strategies (strategy/homogeneity.py and the
hooks in search_acs) against jxl_tpu, on the CPU.

- The homogeneity statistics on the same seeded planes: similarity indices
  allclose (float32 sums reduce in another order in each framework:
  rtol 1e-5, atol 1e-6), thresholds equal, partition maps equal except
  where a ratio sits within 1e-5 of a threshold (counted, at most 1% of
  blocks), the decision rule equal on hand-set ratios, the hook-B factor
  allclose.
- Every non-BASELINE strategy encodes a 64x80 image within 0.5% of the
  reference's bytes and 0.02 dB of its PSNR; the count of differing ACS
  decisions is printed. `JXL_TPU_HOOKA_EPS` stays at its default for these:
  the reference reads it when it traces, so a change mid-process would not
  reach a program it already compiled.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.codec.config import Strategy as JaxStrategy
from jxl_tpu.codec.decode import decode_bytes as jax_decode
from jxl_tpu.codec.encode import encode_image as jax_encode
from jxl_tpu.core.xyb import srgb_to_xyb as jax_srgb_to_xyb
from jxl_tpu.strategy import homogeneity as jh

from jxl_tpu_torch.codec.config import CodecConfig, Strategy
from jxl_tpu_torch.codec.container import read_container
from jxl_tpu_torch.codec.decode import decode_bytes, decode_values
from jxl_tpu_torch.codec.encode import encode_image
from jxl_tpu_torch.strategy import homogeneity as th

from tests.conftest import make_test_image
from tests.test_torch_encode import psnr, sections

DISTANCES = [1.0, 2.0, 3.0, 5.0, 10.0, 10.5, 14.0]
RTOL, ATOL = 1e-5, 1e-6


def _image_planes(h=64, w=80, seed=3):
    """The codec's [X, Y, B - Y] planes of a test image, from the
    reference's colour transform (the statistics are under test, not XYB)."""
    img = make_test_image(h, w, seed=seed)
    xyb = np.asarray(jax_srgb_to_xyb(jnp.asarray(img, jnp.float32) / 255.0))
    return np.stack([xyb[..., 0], xyb[..., 1], xyb[..., 2] - xyb[..., 1]]).astype(np.float32)


def _seeded_planes():
    """The planes of tests/test_homogeneity.py (32x40, seed 5)."""
    rng = np.random.default_rng(5)
    h, w = 32, 40
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yp = 0.4 + 0.3 * np.sin(xx / 5) + 0.1 * rng.normal(size=(h, w)).astype(np.float32)
    xp = 0.01 * rng.normal(size=(h, w)).astype(np.float32)
    bp = yp * 0.9 + 0.05 * rng.normal(size=(h, w)).astype(np.float32)
    return np.stack([xp, yp, bp]).astype(np.float32)


PLANES = {"seeded": _seeded_planes, "image": _image_planes}


@pytest.mark.parametrize("planes_name", sorted(PLANES))
@pytest.mark.parametrize("d", [1.0, 4.0, 12.0])
def test_similarity_indices_and_factor(planes_name, d):
    planes = PLANES[planes_name]()
    ref = [np.asarray(r) for r in jh.homogeneity_similarity_indices(jnp.asarray(planes), d)]
    got = [r.numpy() for r in th.homogeneity_similarity_indices(torch.from_numpy(planes), d)]
    for name, a, b in zip(("r_h", "r_v", "r_d"), got, ref):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=name)
    sub_ref = jh.homogeneity_all_subblocks(jnp.asarray(planes), d)
    sub_got = th.homogeneity_all_subblocks(torch.from_numpy(planes), d)
    for name in sub_ref:
        np.testing.assert_allclose(sub_got[name].numpy(), np.asarray(sub_ref[name]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        th.hook_b_factor(*[torch.tensor(r) for r in ref]).numpy(),
        np.asarray(jh.hook_b_factor(*[jnp.asarray(r) for r in ref])),
        rtol=RTOL, atol=ATOL,
    )

    # partition: equal, except where a ratio is within 1e-5 of the threshold
    part_ref = np.asarray(jh.homogeneity_partition(*[jnp.asarray(r) for r in ref], d))
    part_got = th.homogeneity_partition(*[torch.from_numpy(r) for r in got], d).numpy()
    t = th.partition_threshold(d)
    near = np.zeros(part_ref.shape, bool)
    for a in got:
        near |= np.abs(a - t) <= 1e-5 * t
    flips = part_got != part_ref
    print(f"{planes_name} d={d}: partition flips {int(flips.sum())}/{flips.size}, near threshold {int(near.sum())}")
    assert not (flips & ~near).any()
    assert flips.sum() <= 0.01 * flips.size
    # with the reference's own ratios the rule itself must agree everywhere
    same_in = th.homogeneity_partition(*[torch.tensor(r) for r in ref], d).numpy()
    np.testing.assert_array_equal(same_in, part_ref)


@pytest.mark.parametrize("d", DISTANCES)
def test_thresholds_equal(d):
    assert np.float32(th.laplacian_edge_threshold(d)) == np.asarray(jh.laplacian_edge_threshold(d))
    assert np.float32(th.partition_threshold(d)) == np.asarray(jh.partition_threshold(d))


def test_partition_decision_rule():
    cases = [
        ((2.0, 1.9, 1.7), th.ACS_DCT4X4),  # r_d over the threshold wins
        ((1.7, 1.0, 1.0), th.ACS_DCT8X4),
        ((1.0, 1.7, 1.0), th.ACS_DCT4X8),
        ((1.3, 1.2, 1.1), th.ACS_DCT),
        ((float("nan"),) * 3, th.ACS_DCT),  # degenerate 0/0 blocks keep DCT
    ]
    for (rh, rv, rd), want in cases:
        mk = [torch.full((1, 1), v, dtype=torch.float32) for v in (rh, rv, rd)]
        got = int(th.homogeneity_partition(*mk, 5.0)[0, 0])
        ref = int(jh.homogeneity_partition(*[jnp.full((1, 1), v, jnp.float32) for v in (rh, rv, rd)], 5.0)[0, 0])
        assert got == ref == want


@pytest.mark.parametrize(
    "strategy",
    ["HOMOGENEITY_PARTITIONING", "HOMOGENEITY_FACTORED_ENTROPY", "COMBINED", "HOMOGENEITY_RD_GATED"],
)
def test_strategy_containers_match_reference(strategy):
    img = make_test_image(64, 80, seed=3)
    jax_data = jax_encode(img, JaxConfig(distance=1.0, effort=7, strategy=JaxStrategy[strategy]))
    port_data = encode_image(img, CodecConfig(distance=1.0, effort=7, strategy=Strategy[strategy]), device="cpu")
    assert read_container(port_data).header.strategy == Strategy[strategy].value
    q_jax = psnr(img, np.asarray(jax_decode(jax_data)))
    q_port = psnr(img, np.asarray(jax_decode(port_data)))
    rel = len(port_data) / len(jax_data) - 1.0
    acs_flips = int((sections(jax_data)[1] != sections(port_data)[1]).sum())
    print(
        f"{strategy}: bytes {len(port_data)} vs {len(jax_data)} ({rel:+.4%}), "
        f"PSNR {q_port:.4f} vs {q_jax:.4f} dB, ACS decisions differing: {acs_flips}"
    )
    assert abs(rel) <= 0.005
    assert abs(q_port - q_jax) <= 0.02
    assert np.abs(decode_bytes(jax_data, device="cpu").astype(np.int32) - np.asarray(jax_decode(jax_data))).max() <= 1


def test_rd_gate_reads_eps_on_each_encode(monkeypatch):
    """The port reads JXL_TPU_HOOKA_EPS on every encode: a margin that lets
    every override through makes the RD-gated strategy choose exactly as the
    unconditional one; the default margin chooses otherwise on this image."""
    img = make_test_image(64, 80, seed=3)

    def acs_of(strategy):
        data = encode_image(img, CodecConfig(distance=1.0, effort=7, strategy=strategy), device="cpu")
        return sections(data)[1], decode_values(read_container(data), "cpu")

    acs_part, vals_part = acs_of(Strategy.HOMOGENEITY_PARTITIONING)
    acs_gated, _ = acs_of(Strategy.HOMOGENEITY_RD_GATED)
    assert (acs_gated != acs_part).any()
    monkeypatch.setenv("JXL_TPU_HOOKA_EPS", "1e30")
    acs_open, vals_open = acs_of(Strategy.HOMOGENEITY_RD_GATED)
    np.testing.assert_array_equal(acs_open, acs_part)
    assert torch.equal(vals_open, vals_part)
