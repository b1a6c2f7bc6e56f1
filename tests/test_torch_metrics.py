"""The port's metric battery (jxl_tpu_torch/metrics) against jxl_tpu's on the
same inputs, on the CPU.

Images at 48x64, 37x53 (odd tails: the two downsamplers differ there) and
20x24 (MS-SSIM stops after one scale; Butteraugli's sigma-16 pad of 48
exceeds the image), each against five distortions: identity, uniform
noise, a 3x3 box blur, and the port's codec at d = 1 and d = 4. Inputs are
made from numpy seeds and handed to both packages as numpy arrays.

Bars (port vs reference), with the largest differences measured over these
cases when they were set:

| metric | bar | measured max |
|---|---|---|
| MSE | relative 1e-6 | 8.5e-8 (20x24 blur) |
| PSNR | 1e-5 dB | 3.7e-7 dB |
| SSIM, MS-SSIM | absolute 1e-5 | 5.2e-6 (SSIM, 48x64 d=4); 8.9e-7 |
| Butteraugli max | relative 3e-4 | 1.5e-4 (37x53 blur) |
| Butteraugli 3-norm | relative 1e-4 | 1.1e-5 |
| SSIMULACRA2 | absolute 0.05 | 0.018 (37x53 blur) |

SSIMULACRA2 and the Butteraugli max cannot be held to 1e-3 and 1e-4 by an
implementation that is not bit-identical to the reference's XLA program: at
the coarse scales of a small image the (1 - SSIM) maps are float32
cancellation noise (E[a^2] - E[a]^2 against c2 = 9e-4), and a max is one
pixel's rounding. The reference itself moves by up to 0.009 (SSIMULACRA2)
and 8.7e-5 (Butteraugli max, relative) on these cases when its input is
transposed, which leaves the exact value unchanged
(`test_reference_s2_is_float_noise_bound`).
"""

import numpy as np
import pytest
import torch

import jxl_tpu.metrics as jm
from jxl_tpu.metrics import battery as jb
from jxl_tpu.metrics import perceptual as jp
from jxl_tpu.metrics import quality as jq

import jxl_tpu_torch.metrics as tm
from jxl_tpu_torch.metrics import battery as tb
from jxl_tpu_torch.metrics import perceptual as tp
from jxl_tpu_torch.metrics import quality as tq

from tests.conftest import make_test_image

SIZES = [(48, 64), (37, 53), (20, 24)]
DISTORTIONS = ["identity", "noise", "blur", "d1", "d4"]
CASES = [(s, d) for s in SIZES for d in DISTORTIONS]
IDS = [f"{h}x{w}-{d}" for (h, w), d in CASES]

MSE_REL = 1e-6
PSNR_DB = 1e-5
SSIM_ABS = 1e-5
BA_MAX_REL = 3e-4
BA_P3_REL = 1e-4
S2_ABS = 0.05


def _distort(img: np.ndarray, kind: str, seed: int) -> np.ndarray:
    if kind == "identity":
        return img.copy()
    if kind == "noise":
        rng = np.random.default_rng(seed)
        return np.clip(img.astype(np.int32) + rng.integers(-12, 13, img.shape), 0, 255).astype(np.uint8)
    if kind == "blur":
        p = np.pad(img.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="edge")
        h, w = img.shape[:2]
        s = sum(p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3))
        return ((s + 4) // 9).astype(np.uint8)
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.encode import encode_image

    d = {"d1": 1.0, "d4": 4.0}[kind]
    return decode_bytes(encode_image(img, CodecConfig(distance=d, modular=False), device="cpu"), device="cpu")


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for (h, w), kind in CASES:
        img = make_test_image(h, w, seed=h + w)
        out[(h, w), kind] = (img, _distort(img, kind, seed=h * w))
    return out


@pytest.fixture(scope="module")
def batteries(pairs):
    """(reference, port) battery dicts per case."""
    return {k: (jb.metric_battery(a, b), tb.metric_battery(a, b, device="cpu")) for k, (a, b) in pairs.items()}


def _close_rel(p: float, r: float, rel: float) -> bool:
    return abs(p - r) <= rel * abs(r)


def _check_battery(p: dict, r: dict):
    assert _close_rel(p["mse"], r["mse"], MSE_REL), (p["mse"], r["mse"])
    if np.isinf(r["psnr"]):
        assert np.isinf(p["psnr"])
    else:
        assert abs(p["psnr"] - r["psnr"]) <= PSNR_DB
    for k in ("ssim", "ms_ssim"):
        assert abs(p[k] - r[k]) <= SSIM_ABS, (k, p[k], r[k])
    for k, rel in (("butteraugli", BA_MAX_REL), ("butteraugli_pnorm", BA_P3_REL)):
        assert abs(p[k] - r[k]) <= rel * abs(r[k]), (k, p[k], r[k])
    assert abs(p["ssimulacra2"] - r["ssimulacra2"]) <= S2_ABS, (p["ssimulacra2"], r["ssimulacra2"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_metric_battery_matches_reference(batteries, case):
    r, p = batteries[case]
    _check_battery(p, r)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_calculate_functions_match_reference(pairs, case):
    a, b = pairs[case]
    assert _close_rel(tm.calculate_mse(a, b, device="cpu"), jm.calculate_mse(a, b), MSE_REL)
    rp, pp = jm.calculate_psnr(a, b), tm.calculate_psnr(a, b, device="cpu")
    assert (np.isinf(rp) and np.isinf(pp)) or abs(rp - pp) <= PSNR_DB
    assert abs(tm.calculate_ssim(a, b, device="cpu") - jm.calculate_ssim(a, b)) <= SSIM_ABS
    assert abs(tm.calculate_ms_ssim(a, b, device="cpu") - jm.calculate_ms_ssim(a, b)) <= SSIM_ABS
    for pv, rv, rel in zip(tm.calculate_butteraugli(a, b, device="cpu"), jm.calculate_butteraugli(a, b), (BA_MAX_REL, BA_P3_REL)):
        assert abs(pv - rv) <= rel * abs(rv), (pv, rv)
    assert abs(tm.calculate_ssimulacra2(a, b, device="cpu") - jm.calculate_ssimulacra2(a, b)) <= S2_ABS


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_battery_grid_matches_reference(pairs, batteries, size):
    """A whole row ([N, H, W, 3], every distortion of one image) in one
    battery call against the reference's lax.map over the row and its
    per-pair battery. The reference's row form does not score the identity
    point exactly (Butteraugli 8e-6 to 2e-5 at 20x24 and 37x53); the port's does,
    so that point is held to the reference's per-pair value only."""
    img = pairs[size, "identity"][0]
    stack = np.stack([pairs[size, k][1] for k in DISTORTIONS])
    ref = jb.metric_battery_grid_async(img, stack)()
    got = tb.metric_battery_grid_async(img, stack, device="cpu")()
    assert len(got) == len(ref) == len(DISTORTIONS)
    for kind, p, r in zip(DISTORTIONS, got, ref):
        _check_battery(p, batteries[size, kind][0])
        if kind == "identity":
            assert r["butteraugli"] < 1e-4 and p["butteraugli"] == 0.0
        else:
            _check_battery(p, r)
    with_tensors = tb.metric_battery_grid_async(torch.from_numpy(img), torch.from_numpy(stack))()
    assert with_tensors == got


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_identical_images_score_exactly(pairs, size):
    img = pairs[size, "identity"][0]
    m = tb.metric_battery(img, img, device="cpu")
    assert m["mse"] == 0.0 and m["psnr"] == float("inf")
    assert abs(m["ssim"] - 1.0) <= 1e-6
    assert m["butteraugli"] == 0.0 and m["butteraugli_pnorm"] == 0.0
    assert m["ssimulacra2"] == 100.0
    rows = tb.metric_battery_grid_async(img, np.stack([img, img, img]), device="cpu")()
    assert all(r == rows[0] for r in rows)
    assert rows[0]["butteraugli"] == 0.0 and rows[0]["ssimulacra2"] == 100.0


@pytest.mark.parametrize("n,pad", [(3, 7), (1, 4), (5, 5), (20, 48), (37, 5), (2, 9)])
def test_symmetric_index_matches_numpy_pad(n, pad):
    """The symmetric-pad gather equals np.pad(mode="symmetric"), also for
    pads larger than the axis (torch's "reflect" differs and refuses
    those)."""
    x = np.arange(n) * 10 + 1
    want = np.pad(x, pad, mode="symmetric")
    got = torch.from_numpy(x)[tq.symmetric_index(n, pad, "cpu")].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(20, 24, 3), (37, 53, 3), (5, 6, 3), (1, 1, 3)])
def test_filters_and_downsamplers_match_reference(shape):
    rng = np.random.default_rng(int(np.prod(shape)))
    x = rng.random(shape).astype(np.float32)
    xt = torch.from_numpy(x)
    k = tq._gaussian_kernel(5, 1.5)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jq._gaussian_kernel(5, 1.5)))
    np.testing.assert_allclose(tq._filter2d_sep(xt, k).numpy(), np.asarray(jq._filter2d_sep(x, jq._gaussian_kernel(5, 1.5))), rtol=0, atol=2e-6)
    for sigma in (0.6, 1.5, 16.0):
        np.testing.assert_allclose(tp._blur(xt, sigma).numpy(), np.asarray(jp._blur(x, sigma)), rtol=0, atol=2e-6)
    # the port sums the four samples in a fixed order: within 2 ulp of the reference's mean on [0, 1)
    np.testing.assert_allclose(tp._downsample2(xt).numpy(), np.asarray(jp._downsample2(x)), rtol=0, atol=2.4e-7)
    if min(shape[:2]) >= 2:
        np.testing.assert_allclose(tq._downsample2x(xt).numpy(), np.asarray(jq._downsample2x(x)), rtol=0, atol=1e-7)
    # batched form: a leading axis of two images equals two single calls
    x2 = torch.stack([xt, 1.0 - xt])
    np.testing.assert_array_equal(tp._blur(x2, 1.5)[1].numpy(), tp._blur(1.0 - xt, 1.5).numpy())


def test_ms_ssim_stops_at_the_same_scale():
    """20x24: the 20x24 scale runs, 10x12 is under 11 and stops both."""
    a = make_test_image(20, 24, seed=5)
    b = _distort(a, "noise", seed=3)
    scales = tq.ms_ssim_scales(torch.from_numpy(a)[None], torch.from_numpy(b)[None])
    assert len(scales) == 1
    assert abs(tm.calculate_ms_ssim(a, b, device="cpu") - jm.calculate_ms_ssim(a, b)) <= SSIM_ABS


def test_reference_s2_is_float_noise_bound(pairs):
    """The reference's SSIMULACRA2 on a case and on its transpose (the same
    exact value) differs by more than 1e-3: the bar the port is held to
    cannot be tighter than the reference's own float32 reproducibility."""
    spread = 0.0
    for kind in ("d1", "noise"):
        a, b = pairs[(37, 53), kind]
        r = jm.calculate_ssimulacra2(a, b)
        rt = jm.calculate_ssimulacra2(np.ascontiguousarray(a.transpose(1, 0, 2)), np.ascontiguousarray(b.transpose(1, 0, 2)))
        spread = max(spread, abs(r - rt))
    assert 1e-3 < spread < S2_ABS


def test_file_size_ratio_and_inputs():
    for a in range(4):
        for b in range(4):
            assert tm.file_size_ratio(a, b) == jm.file_size_ratio(a, b)
    img = make_test_image(16, 16)
    with pytest.raises(ValueError):
        tm.calculate_mse(img, img)  # numpy inputs need an explicit device
