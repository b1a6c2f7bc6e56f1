"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: every test skips without a CUDA device (decided inside the
`dev` fixture). The file imports neither jax, nor the test conftest, nor
other test modules, so it runs on a machine without jax:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda -q
"""

import numpy as np
import pytest
import torch

from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_cuda
from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda, encode_grouped_plain
from jxl_tpu_torch.entropy.grouped import decode_grouped, kernel_rows
from jxl_tpu_torch.entropy.rans import quantize_histograms_t
from jxl_tpu_torch.entropy.tokens import ALPHABET, tokenize

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the CUDA kernels with their plain versions")
    return torch.device("cuda:0")


def _stream(T: int, lanes: int, seed: int, dev):
    """Heavy-tailed token stream (some 1-3 byte mantissas) with a few
    context runs, its tables and kernel rows, on `dev`."""
    rng = np.random.default_rng(seed)
    n = T * lanes
    vals = np.minimum((rng.pareto(1.2, n) * 3).astype(np.int64), 1 << 20)
    vals[rng.random(n) < 0.55] = 0
    tok, _nb, mant = tokenize(torch.from_numpy(vals))
    n_ctx = 4
    step_ctx = torch.from_numpy(np.repeat(np.arange(n_ctx), -(-T // n_ctx))[:T])
    counts = torch.bincount(
        torch.repeat_interleave(step_ctx, lanes) * ALPHABET + tok.long(), minlength=n_ctx * ALPHABET
    ).reshape(n_ctx, ALPHABET)
    freq, cum = quantize_histograms_t(counts)
    rows = kernel_rows(step_ctx, freq, cum)
    return tok.to(dev), mant.to(dev), rows.to(dev), vals


def _front(bucket, counts):
    """Back-filled encode bucket [G, cap] -> decode buffer with each group's
    stream at the front of its row, on the bucket's device."""
    G, cap = bucket.shape
    c = counts.tolist()
    out = torch.zeros((G, max(1, max(c))), dtype=torch.int32, device=bucket.device)
    for g in range(G):
        out[g, : c[g]] = bucket[g, cap - c[g] :]
    return out


CASES = [(128, 1), (128, 37), (256, 96), (512, 40), (1024, 17)]


@pytest.mark.parametrize("lanes,T", CASES)
def test_kernels_match_plain(dev, lanes, T):
    tok, mant, rows, vals = _stream(T, lanes, seed=lanes + T, dev=dev)
    capw, capm = enc_caps(T, lanes)
    kw = dict(T=T, lanes=lanes, capw=capw, capm=capm)
    n0 = encode_grouped_cuda.launches
    enc_k = encode_grouped_cuda(tok, mant, rows, **kw)
    enc_p = encode_grouped_plain(tok, mant, rows, **kw)
    assert encode_grouped_cuda.launches == n0 + 1
    for a, b in zip(enc_k, enc_p):
        assert torch.equal(a.cpu(), b.cpu())

    G = lanes // 128
    wg, mg = _front(enc_k[0], enc_k[3]), _front(enc_k[1], enc_k[4])
    ptr0 = torch.zeros((2, G), dtype=torch.int32, device=dev)
    t_a = T // 3
    out = {}
    for name, fn in (("kernel", decode_grouped_cuda), ("plain", decode_grouped)):
        va, st, p = fn(wg, mg, enc_k[2], rows[:t_a].contiguous(), ptr0, T=t_a, lanes=lanes)
        vb, st2, p2 = fn(wg, mg, st, rows[t_a:].contiguous(), p, T=T - t_a, lanes=lanes)
        out[name] = (va, st, p, vb, st2, p2)
    for a, b in zip(out["kernel"], out["plain"]):
        assert torch.equal(a.cpu(), b.cpu())
    got = torch.cat([out["kernel"][0], out["kernel"][3]]).cpu().numpy()
    np.testing.assert_array_equal(got, vals)


def test_encode_overflow_relaunches_kernel(dev):
    lanes, T = 256, 64
    tok, mant, rows, _vals = _stream(T, lanes, seed=4, dev=dev)
    capw, _capm = enc_caps(T, lanes)
    n0 = encode_grouped_cuda.launches
    out = encode_grouped_cuda(tok, mant, rows, T=T, lanes=lanes, capw=capw, capm=128)
    assert encode_grouped_cuda.launches == n0 + 2
    ref = encode_grouped_plain(tok, mant, rows, T=T, lanes=lanes, capw=capw, capm=out[1].shape[1])
    assert out[1].shape[1] > 128 and int(out[4].max()) <= out[1].shape[1]
    for a, b in zip(out, ref):
        assert torch.equal(a.cpu(), b.cpu())


def test_wrappers_reject_mixed_devices(dev):
    lanes, T = 128, 8
    tok, mant, rows, _vals = _stream(T, lanes, seed=1, dev=dev)
    capw, capm = enc_caps(T, lanes)
    with pytest.raises(ValueError):
        encode_grouped_cuda(tok, mant.cpu(), rows, T=T, lanes=lanes, capw=capw, capm=capm)


def test_codec_on_card_matches_cpu(dev):
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_bytes, decode_values
    from jxl_tpu_torch.codec.encode import encode_image

    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    lum = np.clip(0.5 + 0.3 * np.sin(xx / 17.0) * np.cos(yy / 11.0) + rng.normal(0, 0.03, yy.shape), 0, 1)
    img = (np.stack([lum, lum * 0.9, lum * 0.8], axis=-1) * 255).astype(np.uint8)
    data = encode_image(img, CodecConfig(distance=1.0, effort=7), device=dev)
    s = read_container(data)
    assert torch.equal(decode_values(s, dev).cpu(), decode_values(s, "cpu"))
    a = decode_bytes(data, device=dev).astype(np.int32)
    b = decode_bytes(data, device="cpu").astype(np.int32)
    assert np.abs(a - b).max() <= 1
