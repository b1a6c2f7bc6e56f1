"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: every test skips without a CUDA device (decided inside the
`dev` fixture). The file imports neither jax, nor the test conftest, nor
other test modules, so it runs on a machine without jax:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda -q
"""

import numpy as np
import pytest
import torch

from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_batched_cuda, decode_grouped_cuda
from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda, encode_grouped_plain
from jxl_tpu_torch.entropy.grouped import decode_grouped, decode_grouped_batched, kernel_rows
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


def _front(bucket, counts, width=None):
    """Back-filled encode bucket [G, cap] -> decode buffer [G, width] (default:
    the largest count) with each group's stream at the front of its row, on
    the bucket's device."""
    G, cap = bucket.shape
    c = counts.tolist()
    out = torch.zeros((G, width or max(1, max(c))), dtype=torch.int32, device=bucket.device)
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


B2_CASES = [(B, lanes) for B in (1, 3, 8) for lanes in (128, 256, 512)] + [
    (B, lanes) for B in (16, 33, 64) for lanes in (128, 512, 1024)
] + [(1, 1024)]


@pytest.mark.parametrize("B,lanes", B2_CASES)
def test_batched_decode_matches_plain(dev, B, lanes):
    """Kernel B2 against its plain version: B streams of unequal lengths
    (one seed each) at shared caps, both phases joined by the carry; up to
    64 streams x 8 groups (512 CTAs, more than one wave); the first, a
    middle and the last stream also against B1."""
    T = 48
    t_a = T // 3
    G = lanes // 128
    capw, capm = enc_caps(T, lanes)
    enc, rows, vals = [], [], []
    for i in range(B):
        tok, mant, r, v = _stream(T, lanes, seed=100 * B + lanes + i, dev=dev)
        enc.append(encode_grouped_cuda(tok, mant, r, T=T, lanes=lanes, capw=capw, capm=capm))
        rows.append(r)
        vals.append(v)
    ww = max(int(e[3].max()) for e in enc)
    wm = max(int(e[4].max()) for e in enc)
    words = torch.cat([_front(e[0], e[3], ww) for e in enc])
    mants = torch.cat([_front(e[1], e[4], wm) for e in enc])
    states = torch.stack([e[2] for e in enc])
    rows_b = torch.stack(rows, dim=1)
    ptr0 = torch.zeros((2, B * G), dtype=torch.int32, device=dev)
    out = {}
    n0 = decode_grouped_batched_cuda.launches
    for name, fn in (("kernel", decode_grouped_batched_cuda), ("plain", decode_grouped_batched)):
        va, st, p = fn(words, mants, states, rows_b[:t_a].contiguous(), ptr0, T=t_a, lanes=lanes)
        vb, st2, p2 = fn(words, mants, st, rows_b[t_a:].contiguous(), p, T=T - t_a, lanes=lanes)
        out[name] = (va, st, p, vb, st2, p2)
    torch.cuda.synchronize()
    assert decode_grouped_batched_cuda.launches == n0 + 2
    for a, b in zip(out["kernel"], out["plain"]):
        assert torch.equal(a.cpu(), b.cpu())
    got = torch.cat([out["kernel"][0], out["kernel"][3]], dim=1).cpu().numpy()
    for i in range(B):
        np.testing.assert_array_equal(got[i], vals[i])
    for i in sorted({0, B // 2, B - 1}):
        g = slice(i * G, (i + 1) * G)
        single = decode_grouped_cuda(
            words[g], mants[g], states[i], rows_b[:t_a, i].contiguous(), ptr0[:, g].contiguous(), T=t_a, lanes=lanes
        )
        assert torch.equal(single[0].cpu(), out["kernel"][0][i].cpu())


def test_grid_row_on_card(dev):
    """A grid row encoded and decoded on the card: one encode launch per
    point, B2 twice for the row and B1 not at all; values equal the CPU's,
    pixels within 1 LSB of the CPU's."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_bytes_grid_stacked, decode_values_grid
    from jxl_tpu_torch.codec.encode import encode_image_grid

    img = _card_image()
    ds = [0.5, 1.0, 3.0, 8.0]
    e0, b0, s0 = encode_grouped_cuda.launches, decode_grouped_batched_cuda.launches, decode_grouped_cuda.launches
    datas = encode_image_grid(img, CodecConfig(effort=7), ds, device=dev)
    out = decode_bytes_grid_stacked(datas, device=dev)
    torch.cuda.synchronize()
    assert encode_grouped_cuda.launches - e0 >= len(ds)
    assert decode_grouped_batched_cuda.launches - b0 == 2
    assert decode_grouped_cuda.launches == s0
    streams = [read_container(d) for d in datas]
    assert torch.equal(decode_values_grid(streams, dev).cpu(), decode_values_grid(streams, "cpu"))
    ref = decode_bytes_grid_stacked(datas, device="cpu")
    assert out.shape == ref.shape
    assert (out.cpu().to(torch.int32) - ref.to(torch.int32)).abs().max() <= 1


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


def _encode_both(tok, mant, rows, T, lanes):
    """B3 and its plain version at default caps (grown by the wrapper if
    needed), equal on every output; returns the kernel's outputs."""
    capw, capm = enc_caps(T, lanes)
    enc_k = encode_grouped_cuda(tok, mant, rows, T=T, lanes=lanes, capw=capw, capm=capm)
    kw = dict(T=T, lanes=lanes, capw=enc_k[0].shape[1], capm=enc_k[1].shape[1])
    for a, b in zip(enc_k, encode_grouped_plain(tok, mant, rows, **kw)):
        assert torch.equal(a.cpu(), b.cpu())
    return enc_k


def _decode_both(wg, mg, states, rows, ptr0, T, t_a, lanes):
    """B1 and its plain version over both phases (split at t_a, joined by
    the carry), equal on every output; returns the kernel's outputs."""
    out = {}
    for name, fn in (("kernel", decode_grouped_cuda), ("plain", decode_grouped)):
        va, st, p = fn(wg, mg, states, rows[:t_a].contiguous(), ptr0, T=t_a, lanes=lanes)
        vb, st2, p2 = fn(wg, mg, st, rows[t_a:].contiguous(), p, T=T - t_a, lanes=lanes)
        out[name] = (va, st, p, vb, st2, p2)
    for a, b in zip(out["kernel"], out["plain"]):
        assert torch.equal(a.cpu(), b.cpu())
    return out["kernel"]


def _dense_stream(T: int, lanes: int, seed: int, dev):
    """Tokens uniform over the alphabet (most carry 1-3 mantissa bytes, many
    lanes renormalise each step) under one flat context, on `dev`."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 24, T * lanes) >> rng.integers(0, 24, T * lanes)
    tok, _nb, mant = tokenize(torch.from_numpy(vals))
    counts = torch.bincount(tok.long(), minlength=ALPHABET)[None]
    freq, cum = quantize_histograms_t(counts)
    rows = kernel_rows(torch.zeros(T, dtype=torch.int64), freq, cum)
    return tok.to(dev), mant.to(dev), rows.to(dev), vals


def test_rings_wrap_many_times(dev):
    """A dense stream whose words and mantissa bytes pass through the
    decoder's shared-memory rings many times (2048 words, 8192 bytes per
    group) and through the encoder's step ring (16 steps)."""
    lanes, T = 256, 600
    tok, mant, rows, vals = _dense_stream(T, lanes, seed=21, dev=dev)
    enc = _encode_both(tok, mant, rows, T, lanes)
    assert int(enc[3].min()) > 4 * 2048 and int(enc[4].min()) > 8 * 8192
    ptr0 = torch.zeros((2, lanes // 128), dtype=torch.int32, device=dev)
    out = _decode_both(_front(enc[0], enc[3]), _front(enc[1], enc[4]), enc[2], rows, ptr0, T, T // 2, lanes)
    np.testing.assert_array_equal(torch.cat([out[0], out[3]]).cpu().numpy(), vals)
    assert torch.equal(out[5].cpu(), torch.stack([enc[3], enc[4]]).cpu())


def test_phase_b_starts_at_unaligned_carry(dev):
    """Phase B starts where phase A stopped: carry pointers that are not
    multiples of 4 (nor of 16 bytes) for several splits."""
    lanes, T = 384, 90
    tok, mant, rows, vals = _dense_stream(T, lanes, seed=5, dev=dev)
    enc = _encode_both(tok, mant, rows, T, lanes)
    wg, mg = _front(enc[0], enc[3]), _front(enc[1], enc[4])
    ptr0 = torch.zeros((2, lanes // 128), dtype=torch.int32, device=dev)
    odd = 0
    for t_a in (1, 7, 13, 45, 89):
        out = _decode_both(wg, mg, enc[2], rows, ptr0, T, t_a, lanes)
        odd += int((out[2].cpu() % 4 != 0).sum())
        np.testing.assert_array_equal(torch.cat([out[0], out[3]]).cpu().numpy(), vals)
    assert odd > 0


@pytest.mark.parametrize("cut", ["short", "start_past_cap", "start_negative"])
def test_reads_past_bucket_read_zero(dev, cut):
    """Buckets cut short (reads run past the cap), start pointers past the
    cap and before the bucket: every read outside a bucket reads 0, in the
    kernel as in the plain version, on every output."""
    lanes, T = 256, 120
    tok, mant, rows, _vals = _dense_stream(T, lanes, seed=8, dev=dev)
    enc = _encode_both(tok, mant, rows, T, lanes)
    wg, mg = _front(enc[0], enc[3]), _front(enc[1], enc[4])
    G = lanes // 128
    ptr0 = torch.zeros((2, G), dtype=torch.int32, device=dev)
    if cut == "short":
        wg, mg = wg[:, : wg.shape[1] // 3].contiguous(), mg[:, : mg.shape[1] // 5].contiguous()
    elif cut == "start_past_cap":
        ptr0 = torch.tensor([[wg.shape[1] - 37] * G, [mg.shape[1] + 3] * G], dtype=torch.int32, device=dev)
    else:
        ptr0 = torch.tensor([[-301] * G, [-5000] * G], dtype=torch.int32, device=dev)
    _decode_both(wg, mg, enc[2], rows, ptr0, T, T // 3, lanes)


def test_worst_case_step(dev):
    """Every token carries 3 mantissa bytes, and all 128 lanes of a group
    renormalise together at 3 of every 4 steps (identical lanes, 12 bits a
    token): the most a step can consume (128 words, 384 bytes per group),
    the size the decoder's rings are built for."""
    lanes, T = 256, 80
    n = T * lanes
    rng = np.random.default_rng(9)
    vals = np.tile((1 << 24) + rng.integers(0, 1 << 24, T)[:, None], (1, lanes)).reshape(n)  # token 51
    tok, _nb, mant = tokenize(torch.from_numpy(vals))
    assert int(tok.min()) == int(tok.max()) == ALPHABET - 1
    freq = torch.zeros((1, ALPHABET), dtype=torch.int64)
    freq[0, 0], freq[0, ALPHABET - 1] = 4095, 1  # token 51 at 1/4096: 12 bits a step
    cum = torch.cumsum(freq, dim=1) - freq
    rows = kernel_rows(torch.zeros(T, dtype=torch.int64), freq, cum).to(dev)
    enc = _encode_both(tok.to(dev), mant.to(dev), rows, T, lanes)
    assert int(enc[4].min()) == 3 * 128 * T and int(enc[3].min()) >= 128 * (T // 2)
    wg, mg = _front(enc[0], enc[3]), _front(enc[1], enc[4])
    ptr0 = torch.zeros((2, lanes // 128), dtype=torch.int32, device=dev)
    out = _decode_both(wg, mg, enc[2], rows, ptr0, T, T // 2, lanes)
    np.testing.assert_array_equal(torch.cat([out[0], out[3]]).cpu().numpy(), vals)


def test_encode_divides_by_every_frequency(dev):
    """Rows of two symbols at frequencies f and 4096 - f for f = 1..2048,
    and one row of a single symbol at 4096, both symbols in every row: B3
    divides by every f in [1, 4096] (its reciprocal table, and f = 1's own
    path), bit-exact against the plain version on every output; B1 decodes
    the values back."""
    lanes, T = 256, 2049
    freq = torch.zeros((T, ALPHABET), dtype=torch.int64)
    f = torch.arange(1, T, dtype=torch.int64)
    freq[: T - 1, 0], freq[: T - 1, 1] = f, 4096 - f
    freq[T - 1, 0] = 4096
    cum = torch.cumsum(freq, dim=1) - freq
    rows = kernel_rows(torch.arange(T), freq, cum)
    vals = np.random.default_rng(4).integers(0, 2, (T, lanes))
    vals[:, 0], vals[:, 1] = 0, 1
    vals[T - 1] = 0
    vals = vals.reshape(T * lanes)
    tok, _nb, mant = tokenize(torch.from_numpy(vals))
    used = rows[torch.arange(T).repeat_interleave(lanes), tok.long()]
    assert set(used.tolist()) == set(range(1, 4097))
    enc = _encode_both(tok.to(dev), mant.to(dev), rows.to(dev), T, lanes)
    ptr0 = torch.zeros((2, lanes // 128), dtype=torch.int32, device=dev)
    out = _decode_both(_front(enc[0], enc[3]), _front(enc[1], enc[4]), enc[2], rows.to(dev), ptr0, T, T // 2, lanes)
    np.testing.assert_array_equal(torch.cat([out[0], out[3]]).cpu().numpy(), vals)


def test_wrappers_reject_mixed_devices(dev):
    lanes, T = 128, 8
    tok, mant, rows, _vals = _stream(T, lanes, seed=1, dev=dev)
    capw, capm = enc_caps(T, lanes)
    with pytest.raises(ValueError):
        encode_grouped_cuda(tok, mant.cpu(), rows, T=T, lanes=lanes, capw=capw, capm=capm)


def _card_image():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    lum = np.clip(0.5 + 0.3 * np.sin(xx / 17.0) * np.cos(yy / 11.0) + rng.normal(0, 0.03, yy.shape), 0, 1)
    return (np.stack([lum, lum * 0.9, lum * 0.8], axis=-1) * 255).astype(np.uint8)


def test_codec_on_card_matches_cpu(dev):
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_bytes, decode_values
    from jxl_tpu_torch.codec.encode import encode_image

    img = _card_image()
    data = encode_image(img, CodecConfig(distance=1.0, effort=7), device=dev)
    s = read_container(data)
    assert torch.equal(decode_values(s, dev).cpu(), decode_values(s, "cpu"))
    a = decode_bytes(data, device=dev).astype(np.int32)
    b = decode_bytes(data, device="cpu").astype(np.int32)
    assert np.abs(a - b).max() <= 1


def _lossless_stream(dev, h: int = 64, w: int = 96, seed: int = 7):
    """The d = 0 token stream of a uniform-noise image (most residual
    tokens carry 1-2 mantissa bytes, past the default mantissa cap), with
    its kernel rows, on `dev`."""
    from jxl_tpu_torch.codec.encode import entropy_inputs, pick_lanes
    from jxl_tpu_torch.codec.layout import lossless_layout
    from jxl_tpu_torch.codec.lossless import ll_step_ctx, lossless_tokens

    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    lanes = pick_lanes(3 * h * w, 256)
    lay = lossless_layout(h, w, lanes)
    token, _nb, mant, _p, q_sorted = lossless_tokens(torch.from_numpy(img).to(dev), height=h, width=w, distance=0.0)
    tokp, mantp, rows, _freq = entropy_inputs(token, mant, ll_step_ctx(lay, q_sorted), lay, lanes)
    return tokp, mantp, rows, lay, lanes


def test_lossless_stream_kernels_match_plain(dev):
    """B3 on a d = 0 stream relaunches with grown caps and equals its plain
    version at those caps; B1 decodes it in two phases (the activity-map
    split) equal to its plain version and to the encoded values."""
    tokp, mantp, rows, lay, lanes = _lossless_stream(dev)
    T, t_a = lay["T"], lay["t_a"]
    capw, capm = enc_caps(T, lanes)
    n0 = encode_grouped_cuda.launches
    enc_k = encode_grouped_cuda(tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm)
    assert encode_grouped_cuda.launches == n0 + 2 and enc_k[1].shape[1] > capm
    enc_p = encode_grouped_plain(tokp, mantp, rows, T=T, lanes=lanes, capw=enc_k[0].shape[1], capm=enc_k[1].shape[1])
    for a, b in zip(enc_k, enc_p):
        assert torch.equal(a.cpu(), b.cpu())
    G = lanes // 128
    wg, mg = _front(enc_k[0], enc_k[3]), _front(enc_k[1], enc_k[4])
    ptr0 = torch.zeros((2, G), dtype=torch.int32, device=dev)
    out = {}
    for name, fn in (("kernel", decode_grouped_cuda), ("plain", decode_grouped)):
        va, st, p = fn(wg, mg, enc_k[2], rows[:t_a].contiguous(), ptr0, T=t_a, lanes=lanes)
        vb, st2, p2 = fn(wg, mg, st, rows[t_a:].contiguous(), p, T=T - t_a, lanes=lanes)
        out[name] = (va, st, p, vb, st2, p2)
    for a, b in zip(out["kernel"], out["plain"]):
        assert torch.equal(a.cpu(), b.cpu())
    nbits = torch.where(tokp >= 32, tokp - 27, 0)
    expect = torch.where(tokp >= 32, (1 << nbits) + mantp, tokp)
    assert torch.equal(torch.cat([out["kernel"][0], out["kernel"][3]]), expect)


def test_modular_row_on_card(dev):
    """The modular family on the card: a d = 0 encode byte-identical to the
    CPU's and exact; a modular row decoded through B2 (twice, B1 never)
    with values equal to the plain path's on the CPU and equal pixels."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_bytes, decode_bytes_grid_stacked, decode_values_grid
    from jxl_tpu_torch.codec.encode import _modular_grid_async, encode_image, encoder_knobs

    img = _card_image()
    img[20:60, 30:90] = (200, 40, 90)
    data = encode_image(img, CodecConfig(distance=0.0), device=dev)
    assert data == encode_image(img, CodecConfig(distance=0.0), device="cpu")
    np.testing.assert_array_equal(decode_bytes(data, device=dev), img)
    rgb_t = torch.from_numpy(img).to(dev)
    datas = _modular_grid_async(rgb_t, CodecConfig(), [0.5, 1.5, 4.0], "", encoder_knobs())()
    b0, s0 = decode_grouped_batched_cuda.launches, decode_grouped_cuda.launches
    out = decode_bytes_grid_stacked(datas, device=dev)
    torch.cuda.synchronize()
    assert decode_grouped_batched_cuda.launches - b0 == 2 and decode_grouped_cuda.launches == s0
    streams = [read_container(d) for d in datas]
    assert torch.equal(decode_values_grid(streams, dev).cpu(), decode_values_grid(streams, "cpu"))
    assert torch.equal(out.cpu(), decode_bytes_grid_stacked(datas, device="cpu"))


# the bars of tests/test_torch_metrics.py (port vs reference), held here card vs CPU
BATTERY_BARS = {
    "mse": ("rel", 1e-6), "psnr": ("abs", 1e-5), "ssim": ("abs", 1e-5), "ms_ssim": ("abs", 1e-5),
    "butteraugli": ("rel", 3e-4), "butteraugli_pnorm": ("rel", 1e-4), "ssimulacra2": ("abs", 0.05),
}


def _distortions(img):
    rng = np.random.default_rng(11)
    noise = np.clip(img.astype(np.int32) + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)
    p = np.pad(img.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = img.shape[:2]
    blur = ((sum(p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)) + 4) // 9).astype(np.uint8)
    return np.stack([noise, blur, img])


def test_battery_on_card_matches_cpu(dev):
    """The metric battery of a row on the card against the plain path on
    the CPU, every intermediate on the card."""
    from jxl_tpu_torch.metrics.battery import _battery_grid, metric_battery_grid_async

    img = _card_image()
    stack = _distortions(img)
    o, c = torch.from_numpy(img).to(dev), torch.from_numpy(stack).to(dev)
    assert _battery_grid(o, c).device.type == "cuda"
    card = metric_battery_grid_async(o, c)()
    cpu = metric_battery_grid_async(img, stack, device="cpu")()
    for got, want in zip(card, cpu):
        for k, (kind, bar) in BATTERY_BARS.items():
            if want[k] in (0.0, float("inf")):
                assert got[k] == want[k], k
            elif kind == "rel":
                assert abs(got[k] - want[k]) <= bar * abs(want[k]), (k, got[k], want[k])
            else:
                assert abs(got[k] - want[k]) <= bar, (k, got[k], want[k])


def test_identical_images_score_exactly_on_card(dev):
    from jxl_tpu_torch.metrics.battery import metric_battery, metric_battery_grid_async

    img = _card_image()
    t = torch.from_numpy(img).to(dev)
    for m in [metric_battery(t, t)] + metric_battery_grid_async(t, torch.stack([t, t, t]))():
        assert m["mse"] == 0.0 and m["psnr"] == float("inf")
        assert abs(m["ssim"] - 1.0) <= 1e-6
        assert m["butteraugli"] == 0.0 and m["butteraugli_pnorm"] == 0.0
        assert m["ssimulacra2"] == 100.0


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    """A photo-like RGB u8 image of any size made from a seed (smooth
    waves, texture noise, a checker of edges)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    lum = 0.55 + 0.25 * np.sin(xx / 41.0) * np.cos(yy / 29.0) + 0.1 * np.sin((xx + yy) / 97.0)
    lum = lum + rng.normal(0, 0.025, (h, w)).astype(np.float32)
    lum = np.clip(lum + 0.15 * (((xx // 96).astype(np.int32) ^ (yy // 64).astype(np.int32)) % 2), 0, 1)
    rgb = np.stack([lum * (0.85 + 0.15 * np.sin(yy / 83.0)), lum, lum * (0.75 + 0.25 * np.cos(xx / 71.0))], axis=-1)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def test_real_stream_at_1024_lanes_matches_plain(dev):
    """B3 and B1 on the encoder's own stream of a 2048x2816 image (5.8 MP:
    1024 lanes, T >= 16,384, the shape a JXTS stripe gives them), against
    their plain versions at full length, every output bit for bit."""
    from jxl_tpu_torch.codec.encode import _step_ctx_v8, entropy_inputs, pick_lanes, tokens_from_rgb
    from jxl_tpu_torch.codec.layout import padded_layout, token_layout

    h, w = 2048, 2816
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], 256)
    lay = padded_layout(h, w, lanes)
    T, t_a = lay["T"], lay["t_a"]
    assert lanes == 1024 and T >= 16384
    token, _nb, mant, _p, q_sorted, _v = tokens_from_rgb(
        torch.from_numpy(_photo(h, w, seed=3)).to(dev), 1.0, height=h, width=w, effort=7
    )
    tokp, mantp, rows, _f = entropy_inputs(token, mant, _step_ctx_v8(lay, q_sorted), lay, lanes)
    capw, capm = enc_caps(T, lanes)
    kw = dict(T=T, lanes=lanes, capw=capw, capm=capm)
    n0 = encode_grouped_cuda.launches
    enc_k = encode_grouped_cuda(tokp, mantp, rows, **kw)
    assert encode_grouped_cuda.launches == n0 + 1  # a d = 1 stream stays inside the default caps
    for a, b in zip(enc_k, encode_grouped_plain(tokp, mantp, rows, **kw)):
        assert torch.equal(a, b)
    wg, mg = _front(enc_k[0], enc_k[3]), _front(enc_k[1], enc_k[4])
    ptr0 = torch.zeros((2, lanes // 128), dtype=torch.int32, device=dev)
    out = {}
    for name, fn in (("kernel", decode_grouped_cuda), ("plain", decode_grouped)):
        va, st, p = fn(wg, mg, enc_k[2], rows[:t_a].contiguous(), ptr0, T=t_a, lanes=lanes)
        vb, st2, p2 = fn(wg, mg, st, rows[t_a:].contiguous(), p, T=T - t_a, lanes=lanes)
        out[name] = (va, st, p, vb, st2, p2)
    for a, b in zip(out["kernel"], out["plain"]):
        assert torch.equal(a, b)
    assert torch.equal(out["kernel"][5], torch.stack([enc_k[3], enc_k[4]]))  # consumed exactly what was written


def test_striped_container_on_card_matches_cpu(dev):
    """A striped JXTS container on the card: sections byte-identical to the
    CPU's encode, the stitched decode within 1 LSB of the CPU's, B3 once
    and B1 twice per section; and the sharded form over slots of the card
    gives the same bytes."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.tiled import encode_image_striped, encode_image_striped_sharded, read_striped
    from jxl_tpu_torch.distributed.mesh import make_mesh

    img = _photo(256, 768, seed=5)
    cfg = CodecConfig(distance=3.0, effort=7)
    e0, d0 = encode_grouped_cuda.launches, decode_grouped_cuda.launches
    data = encode_image_striped(img, cfg, n_stripes=3, device=dev)
    out = decode_bytes(data, device=dev)
    torch.cuda.synchronize()
    assert encode_grouped_cuda.launches - e0 == 3 and decode_grouped_cuda.launches - d0 == 6
    ref = encode_image_striped(img, cfg, n_stripes=3, device="cpu")
    sizes = [(len(a), len(b)) for a, b in zip(read_striped(data)[2], read_striped(ref)[2])]
    assert all(abs(a - b) <= 0.005 * b for a, b in sizes), sizes  # float order may flip a near-tie decision
    assert np.abs(out.astype(np.int32) - decode_bytes(data, device="cpu")).max() <= 1
    assert encode_image_striped_sharded(img, cfg, make_mesh([dev] * 3)) == data


@pytest.mark.parametrize("lanes", [1, 256])
def test_standalone_coder_on_card_matches_cpu(dev, lanes):
    """The standalone interleaved coder and the mantissa packers on the card
    equal their CPU results bit for bit, and the card decodes its own
    stream; no kernel is launched."""
    from jxl_tpu_torch.entropy import rans as tr
    from jxl_tpu_torch.entropy import tokens as tt

    rng = np.random.default_rng(lanes)
    n, n_ctx = 20000, 9
    tok = np.minimum(rng.geometric(0.3, n) - 1, ALPHABET - 1)
    ctx = rng.integers(0, n_ctx - 1, n)  # the last context is unused
    counts = np.zeros((n_ctx, ALPHABET), np.int64)
    np.add.at(counts, (ctx, tok), 1)
    freq, cum = tr.quantize_histograms(counts)
    e0, d0 = encode_grouped_cuda.launches, decode_grouped_cuda.launches
    card = tr.rans_encode(tok, ctx, freq, cum, lanes, device=dev)
    cpu = tr.rans_encode(tok, ctx, freq, cum, lanes, device="cpu")
    assert all(a.device == dev for a in card)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    back = tr.rans_decode(card[0], card[2], ctx, freq, cum, n, lanes, device=dev)
    np.testing.assert_array_equal(back.cpu().numpy(), tok)

    vals = torch.from_numpy(rng.integers(0, 1 << 24, n))
    _t, nbits, mant = (a.to(dev) for a in tokenize(vals))
    words, _bits = tt.pack_bits(nbits, mant, tt.bit_capacity_words(n))
    assert torch.equal(words.cpu(), tt.pack_bits(nbits.cpu(), mant.cpu(), tt.bit_capacity_words(n))[0])
    assert torch.equal(tt.unpack_bits(nbits, words).cpu(), mant.cpu().long())
    mbytes, _total = tt.pack_bytes(nbits, mant, tt.byte_capacity(n))
    assert torch.equal(tt.unpack_bytes(nbits, mbytes).cpu(), mant.cpu().long())
    torch.cuda.synchronize()
    assert (encode_grouped_cuda.launches, decode_grouped_cuda.launches) == (e0, d0)
