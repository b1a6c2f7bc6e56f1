"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: every test skips without a CUDA device (decided inside the
`dev` fixture). The file imports neither jax, nor the test conftest, nor
other test modules, so it runs on a machine without jax:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda -q
"""

import os

import numpy as np
import pytest
import torch

from jxl_tpu_torch.codec.screen import screen_count, screen_plain, screen_stride
from jxl_tpu_torch.cuda_build import launch_counts
from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_batched_cuda, decode_grouped_cuda
from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda, encode_grouped_plain
from jxl_tpu_torch.entropy.grouped import decode_grouped, decode_grouped_batched, kernel_rows
from jxl_tpu_torch.entropy.rans import quantize_histograms_t
from jxl_tpu_torch.entropy.tokens import ALPHABET, tokenize

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    n0 = launch_counts()["rans_encode"]
    enc_k = encode_grouped_cuda(tok, mant, rows, **kw)
    enc_p = encode_grouped_plain(tok, mant, rows, **kw)
    assert launch_counts()["rans_encode"] == n0 + 1
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
    n0 = launch_counts()["rans_decode_batched"]
    for name, fn in (("kernel", decode_grouped_batched_cuda), ("plain", decode_grouped_batched)):
        va, st, p = fn(words, mants, states, rows_b[:t_a].contiguous(), ptr0, T=t_a, lanes=lanes)
        vb, st2, p2 = fn(words, mants, st, rows_b[t_a:].contiguous(), p, T=T - t_a, lanes=lanes)
        out[name] = (va, st, p, vb, st2, p2)
    torch.cuda.synchronize()
    assert launch_counts()["rans_decode_batched"] == n0 + 2
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


def _since(c0: dict) -> dict:
    """Launches of each entry since the snapshot c0, once the card is done."""
    torch.cuda.synchronize()
    return {k: v - c0[k] for k, v in launch_counts().items()}


@pytest.mark.parametrize("strategy", ["BASELINE", "HOMOGENEITY_PARTITIONING", "HOMOGENEITY_FACTORED_ENTROPY", "COMBINED",
                                      "HOMOGENEITY_RD_GATED"])
def test_grid_row_on_card(dev, strategy):
    """A grid row encoded and decoded on the card under each strategy: one
    encode launch per point, the screen once, B2 twice for the row and B1
    not at all; values equal the CPU's, pixels within 1 LSB of the CPU's;
    BASELINE's containers equal encode_image's."""
    from jxl_tpu_torch.codec.config import CodecConfig, Strategy
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_bytes_grid_stacked, decode_values_grid
    from jxl_tpu_torch.codec.encode import encode_image, encode_image_grid

    img = _card_image()
    ds = [0.5, 1.0, 3.0, 8.0]
    c0 = launch_counts()
    datas = encode_image_grid(img, CodecConfig(effort=7, strategy=Strategy[strategy]), ds, device=dev)
    out = decode_bytes_grid_stacked(datas, device=dev)
    n = _since(c0)
    assert n["rans_encode"] >= len(ds) and n["screen"] == 1
    assert n["rans_decode_batched"] == 2 and n["rans_decode"] == 0
    if strategy == "BASELINE":
        assert datas == [encode_image(img, CodecConfig(distance=d, effort=7), device=dev) for d in ds]
    streams = [read_container(d) for d in datas]
    assert torch.equal(decode_values_grid(streams, dev).cpu(), decode_values_grid(streams, "cpu"))
    ref = decode_bytes_grid_stacked(datas, device="cpu")
    assert out.shape == ref.shape
    assert (out.cpu().to(torch.int32) - ref.to(torch.int32)).abs().max() <= 1


def test_encode_overflow_relaunches_kernel(dev):
    lanes, T = 256, 64
    tok, mant, rows, _vals = _stream(T, lanes, seed=4, dev=dev)
    capw, _capm = enc_caps(T, lanes)
    n0 = launch_counts()["rans_encode"]
    out = encode_grouped_cuda(tok, mant, rows, T=T, lanes=lanes, capw=capw, capm=128)
    assert launch_counts()["rans_encode"] == n0 + 2
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


@pytest.fixture
def dct_calls(monkeypatch):
    """Every dct2d / idct2d call of the codec (the names strategy.acs and
    codec.decode call), recorded as (on CUDA, numel, larger side);
    `.expected_d1()` is what D1 must launch for them: one a call with samples,
    two above side 64."""
    from jxl_tpu_torch.codec import decode as dec_mod
    from jxl_tpu_torch.strategy import acs as acs_mod

    class Calls(list):
        def expected_d1(self):
            return sum((2 if side > 64 else 1) for _cuda, numel, side in self if numel)

    calls = Calls()

    def counted(fn):
        def wrapper(x):
            calls.append((x.is_cuda, x.numel(), max(x.shape[-2:])))
            return fn(x)

        return wrapper

    for mod, name in ((acs_mod, "dct2d"), (acs_mod, "idct2d"), (dec_mod, "idct2d")):
        monkeypatch.setattr(mod, name, counted(getattr(mod, name)))
    return calls


def _bench_image():
    from jxl_tpu_torch.bench.headline import synth_kodak

    return synth_kodak()  # bench.py's image, 512x768, seed 0


def _synth02():
    from jxl_tpu_torch.core.io import read_png_rgb8

    return read_png_rgb8(os.path.join(REPO, "test_images", "synth", "synth02.png"))  # 512x768, 65 colours


# the bench image at d=1 e7 (hardware-independent): 38.4292 dB, 1.5312 bpp
ANCHOR_PSNR_DB, PSNR_TOL_DB = 38.43, 0.05
ANCHOR_BPP, BPP_TOL_REL = 1.5313, 0.005

CODEC_CASES = {  # image, distance, effort
    "card d=1 e7": (_card_image, 1.0, 7),
    "bench d=1 e7": (_bench_image, 1.0, 7),
    "bench d=1 e8": (_bench_image, 1.0, 8),
    "bench d=1 e9": (_bench_image, 1.0, 9),
    "synth02 d=0": (_synth02, 0.0, 7),
    "bench d=0": (_bench_image, 0.0, 7),
}


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_codec_on_card_matches_cpu(dev, case, dct_calls):
    """encode_image and decode_bytes on the card: the value stream equal to
    the CPU's decode of the same bytes, pixels within 1 LSB of it, and D1
    launched exactly for the codec's DCT calls. The main path (d=1 e7)
    launches B3 once, B1 twice, the screen once, H1 twice and B2 never
    (H1 three times at e8-e9: the front end runs twice), and the bench
    image meets its quality anchor; d = 0 round-trips exactly, synth02 on
    the palette arm, the bench image on the plain one."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_bytes, decode_values
    from jxl_tpu_torch.codec.encode import encode_image

    make, distance, effort = CODEC_CASES[case]
    img = make()
    c0 = launch_counts()
    data = encode_image(img, CodecConfig(distance=distance, effort=effort), device=dev)
    a = decode_bytes(data, device=dev).astype(np.int32)
    n = _since(c0)
    assert all(cuda for cuda, _n, _side in dct_calls) and n["dct2d"] == dct_calls.expected_d1()
    s = read_container(data)
    assert torch.equal(decode_values(s, dev).cpu(), decode_values(s, "cpu"))
    b = decode_bytes(data, device="cpu").astype(np.int32)
    assert np.abs(a - b).max() <= 1
    assert n["rans_encode"] >= 1 and n["rans_decode"] >= 2 and n["rans_decode_batched"] == 0
    if (distance, effort) == (1.0, 7):
        assert (n["rans_encode"], n["rans_decode"], n["screen"], n["hist"]) == (1, 2, 1, 2) and n["dct2d"] >= 1
    if distance > 0 and effort >= 8:
        assert n["hist"] == 3  # the front end twice, the stream's tables once
    if case == "bench d=1 e7":
        mse = np.mean((a - img.astype(np.int32)) ** 2)
        assert abs(10 * np.log10(255.0**2 / mse) - ANCHOR_PSNR_DB) <= PSNR_TOL_DB
        assert abs(len(data) * 8 / (img.shape[0] * img.shape[1]) - ANCHOR_BPP) <= BPP_TOL_REL * ANCHOR_BPP
    if distance == 0.0:
        np.testing.assert_array_equal(a, img)
        assert bool(s.acs_extra) is (case == "synth02 d=0")


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
    n0 = launch_counts()["rans_encode"]
    enc_k = encode_grouped_cuda(tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm)
    assert launch_counts()["rans_encode"] == n0 + 2 and enc_k[1].shape[1] > capm
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
    b0, s0 = launch_counts()["rans_decode_batched"], launch_counts()["rans_decode"]
    out = decode_bytes_grid_stacked(datas, device=dev)
    torch.cuda.synchronize()
    assert launch_counts()["rans_decode_batched"] - b0 == 2 and launch_counts()["rans_decode"] == s0
    streams = [read_container(d) for d in datas]
    assert torch.equal(decode_values_grid(streams, dev).cpu(), decode_values_grid(streams, "cpu"))
    assert torch.equal(out.cpu(), decode_bytes_grid_stacked(datas, device="cpu"))


# the bars of tests/test_torch_metrics.py (port vs reference), held here card vs CPU
BATTERY_BARS = {
    "mse": ("rel", 1e-6), "psnr": ("abs", 1e-5), "ssim": ("abs", 1e-5), "ms_ssim": ("abs", 1e-5),
    "butteraugli": ("rel", 3e-4), "butteraugli_pnorm": ("rel", 1e-4), "ssimulacra2": ("abs", 0.05),
}


def _assert_within_bars(got: dict, want: dict):
    for k, (kind, bar) in BATTERY_BARS.items():
        if want[k] in (0.0, float("inf")):
            assert got[k] == want[k], k
        elif kind == "rel":
            assert abs(got[k] - want[k]) <= bar * abs(want[k]), (k, got[k], want[k])
        else:
            assert abs(got[k] - want[k]) <= bar, (k, got[k], want[k])


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
        _assert_within_bars(got, want)


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
    n0 = launch_counts()["rans_encode"]
    enc_k = encode_grouped_cuda(tokp, mantp, rows, **kw)
    assert launch_counts()["rans_encode"] == n0 + 1  # a d = 1 stream stays inside the default caps
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


def _mixed(h: int = 512, w: int = 768) -> np.ndarray:
    """A UI page (flat, with bars of text) beside a photo."""
    from jxl_tpu_torch.bench.headline import synth_kodak

    rng = np.random.default_rng(42)
    ui = np.full((h, w // 2, 3), 240, np.uint8)
    for _ in range(96):
        y, x = rng.integers(0, h - 8), rng.integers(0, w // 2 - 44)
        ui[y : y + 6, x : x + int(rng.integers(10, 40))] = [40, 40, 90]
    return np.concatenate([ui, synth_kodak(h, w - w // 2, seed=11)], axis=1)


@pytest.mark.parametrize("case", ["photo", "mixed", "d0"])
def test_striped_container_on_card_matches_cpu(dev, case):
    """A striped JXTS container on the card: the stitched decode within
    1 LSB of the CPU's. A photo at d=3 in 3 stripes: sections the size of
    the CPU's encode, B3 once and B1 twice per section, and the sharded
    form over slots of the card (VarDCT only) gives the same bytes. UI
    beside a photo at d=1 e5 in 4 stripes: modular and VarDCT sections in
    one container, above 30 dB. The bench image at d=0 in 3 stripes:
    exact."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container_header
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.tiled import encode_image_striped, encode_image_striped_sharded, read_striped
    from jxl_tpu_torch.distributed.mesh import make_mesh

    if case == "photo":
        img, cfg, k = _photo(256, 768, seed=5), CodecConfig(distance=3.0, effort=7), 3
    elif case == "mixed":
        img, cfg, k = _mixed(), CodecConfig(distance=1.0, effort=5), 4
    else:
        img, cfg, k = _bench_image(), CodecConfig(distance=0.0, effort=7), 3
    c0 = launch_counts()
    data = encode_image_striped(img, cfg, n_stripes=k, device=dev)
    out = decode_bytes(data, device=dev)
    n = _since(c0)
    assert np.abs(out.astype(np.int32) - decode_bytes(data, device="cpu")).max() <= 1
    if case == "photo":
        assert n["rans_encode"] == 3 and n["rans_decode"] == 6
        assert encode_image_striped_sharded(img, cfg, make_mesh([dev] * 3)) == data
        ref = encode_image_striped(img, cfg, n_stripes=3, device="cpu")
        sizes = [(len(a), len(b)) for a, b in zip(read_striped(data)[2], read_striped(ref)[2])]
        assert all(abs(a - b) <= 0.005 * b for a, b in sizes), sizes  # float order may flip a near-tie decision
    elif case == "d0":
        assert len(read_striped(data)[2]) == 3
        np.testing.assert_array_equal(out, img)
    else:
        modes = [read_container_header(sec).lossless for sec in read_striped(data)[2]]
        assert any(modes) and not all(modes), modes
        mse = np.mean((out.astype(np.float64) - img) ** 2)
        assert 10 * np.log10(255.0**2 / mse) > 30.0


@pytest.mark.parametrize("distance", [1.0, 3.0])
def test_striped_seams_on_card(dev, distance):
    """The bench image in 3 stripes on the card: the stitched decode equals
    the paste of the sections' own decodes more than 8 px from every seam;
    within 8 px of one it differs somewhere exactly when the sections
    signal EPF (the filter reads across the seam), which they do at d=3;
    pixels within 1 LSB of the CPU's decode of the same bytes."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container_header
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.tiled import encode_image_striped, read_striped, stripe_widths

    img = _bench_image()
    seams = np.cumsum(stripe_widths(img.shape[1], 3))[:-1]
    data = encode_image_striped(img, CodecConfig(distance=distance, effort=7), n_stripes=3, device=dev)
    sections = read_striped(data)[2]
    out = decode_bytes(data, device=dev)
    naive = np.concatenate([decode_bytes(sec, device=dev) for sec in sections], axis=1)
    epf = [read_container_header(sec).epf for sec in sections]
    assert all(epf) or distance < 3.0, epf
    cols = np.arange(img.shape[1])
    near = (np.abs(cols[:, None] - seams[None, :] + 0.5) <= 8).any(axis=1)
    differs = (out != naive).any(axis=(0, 2))
    assert not differs[~near].any()
    assert bool(differs[near].any()) == all(epf)
    assert np.abs(out.astype(np.int32) - decode_bytes(data, device="cpu")).max() <= 1


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
    e0, d0 = launch_counts()["rans_encode"], launch_counts()["rans_decode"]
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
    assert (launch_counts()["rans_encode"], launch_counts()["rans_decode"]) == (e0, d0)


def _graphics(h: int, w: int, seed: int) -> np.ndarray:
    """Screen-like content of any size: a flat page, a flat box, a bar and
    a band that differ from the page in one channel only, and a patch of
    0/1 noise."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 230, np.uint8)
    img[h // 8 : h // 3, w // 10 : 9 * w // 10] = (20, 30, 40)
    img[:, w // 2 : w // 2 + 2, 2] = 231
    img[h // 2 : h // 2 + 3, :, 0] = 229
    img[2 * h // 3 :, : w // 3] = rng.integers(0, 2, (h - 2 * h // 3, w // 3, 3), dtype=np.uint8)
    return img


SCREEN_CONTENT = {
    "random": lambda h, w, seed: np.random.default_rng(seed).integers(0, 2, (h, w, 3), dtype=np.uint8),
    "photo": _photo,
    "graphics": _graphics,
    "flat": lambda h, w, seed: np.full((h, w, 3), seed % 256, np.uint8),
}


@pytest.mark.parametrize("content", list(SCREEN_CONTENT))
@pytest.mark.parametrize("h,w", [(3024, 4032), (512, 768), (4097, 4096), (2, 2), (1, 64)])
def test_screen_kernel_matches_plain(dev, h, w, content):
    """The screen kernel's count equals the plain version's, on the CPU and
    on the card, one launch a frame with a position to count (4097x4096 is
    screened at stride 4)."""
    img = torch.from_numpy(SCREEN_CONTENT[content](h, w, seed=h + w))
    want = screen_count(img)
    n0 = launch_counts()["screen"]
    got = screen_count(img.to(dev))
    assert got == want
    assert launch_counts()["screen"] == n0 + (want[1] > 0)
    if want[1] > 0:
        assert screen_plain(img.to(dev), screen_stride(h, w)) == want[0]
    if content == "flat":
        assert want[0] == want[1]


def test_screen_rejects_what_the_kernel_does_not_take(dev):
    img = torch.zeros((64, 96, 3), dtype=torch.uint8, device=dev)
    n0 = launch_counts()["screen"]
    for bad in (img.transpose(0, 1), img.float(), img[..., 0].contiguous(), torch.zeros_like(img[..., :2])):
        with pytest.raises(ValueError):
            screen_count(bad)
    assert launch_counts()["screen"] == n0


def test_encode_launches_the_screen_once(dev):
    """One encode_image on the card runs the screen through the kernel,
    once; the pre-screen on the card decides as on the CPU (a photo is no
    modular candidate, graphics are)."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.encode import _modular_candidate, encode_image

    n0 = launch_counts()["screen"]
    data = encode_image(_card_image(), CodecConfig(distance=1.0, effort=7), device=dev)
    assert launch_counts()["screen"] == n0 + 1
    assert not read_container(data).header.lossless
    for img, want in ((_card_image(), False), (_graphics(96, 128, seed=4), True)):
        assert _modular_candidate(img, 1) is want
        assert _modular_candidate(torch.from_numpy(img).to(dev), 1) is want
    assert launch_counts()["screen"] == n0 + 3


# ---- H1: the encoder's context histograms (csrc/hist.cu) against torch.bincount on the card


def _h1_checkers(monkeypatch):
    """encode's two histogram names replaced by checkers: each call runs H1
    (one launch) and the plain torch.bincount on the same card tensors,
    holds them equal element for element in int64, and returns H1's
    counts. Returns the list of (form, tokens) checked."""
    from jxl_tpu_torch.codec import encode
    from jxl_tpu_torch.codec.histogram import ac_counts4, ac_counts4_plain, histogram_stepped, histogram_stepped_plain

    seen = []

    def checked(form, kernel, plain):
        def run(tok, *args):
            n0 = launch_counts()["hist"]
            got = kernel(tok, *args)
            assert launch_counts()["hist"] == n0 + 1
            want = plain(tok, *args)
            assert got.dtype == want.dtype == torch.int64 and got.shape == want.shape
            assert torch.equal(got, want), form
            seen.append((form, tok.numel()))
            return got

        return run

    monkeypatch.setattr(encode, "_histogram_stepped", checked("stepped", histogram_stepped, histogram_stepped_plain))
    monkeypatch.setattr(encode, "_ac_counts4", checked("ac", ac_counts4, ac_counts4_plain))
    return seen


def _photo_12mp():
    return _photo(3024, 4032, seed=5)


H1_ENCODES = {  # image, distance, effort, AC-form calls
    "kodak d=1 e7": (_bench_image, 1.0, 7, 1),
    "kodak d=1 e9": (_bench_image, 1.0, 9, 2),
    "12mp d=1 e7": (_photo_12mp, 1.0, 7, 1),
    "12mp d=1 e9": (_photo_12mp, 1.0, 9, 2),
    "kodak d=0 modular": (_bench_image, 0.0, 7, 0),
}


@pytest.mark.parametrize("case", list(H1_ENCODES))
def test_h1_matches_bincount_on_encoder_streams(dev, monkeypatch, case):
    """H1 on the encoder's own inputs (the `_step_ctx_v8` stream and the AC
    tokens of a Kodak-size and a 12 MP frame at d=1 e7 and e9, front end
    twice there; the modular `ll_step_ctx` stream at d = 0) equals
    torch.bincount run on the card, element for element."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.encode import encode_image

    make, distance, effort, n_ac = H1_ENCODES[case]
    seen = _h1_checkers(monkeypatch)
    encode_image(make(), CodecConfig(distance=distance, effort=effort), device=dev)
    forms = [f for f, _n in seen]
    assert forms.count("ac") == n_ac and forms.count("stepped") >= 1
    if case.startswith("12mp"):
        assert min(n for _f, n in seen) > 30_000_000  # tens of millions of tokens a call


def _steps_per_cta(lanes: int) -> int:
    """The stepped form's steps a CTA (csrc/hist.cu: S_TOKENS / lanes)."""
    return 32768 // lanes


def _adversarial_stream(kind: str, lanes: int, dev):
    """(tokp, step_ctx, n_ctx) of one adversarial stream on `dev`."""
    from jxl_tpu_torch.entropy.tokens import ALPHABET

    rng = np.random.default_rng(lanes)
    T = 3 * _steps_per_cta(lanes) + 7  # not a multiple of a CTA's step range
    if kind == "zeros_one_ctx":
        n_ctx, tok, ctx = 5, np.zeros((T, lanes)), np.full(T, 3)
    elif kind == "all_max":
        n_ctx, tok, ctx = 765, np.full((T, lanes), ALPHABET - 1), rng.integers(0, 765, T)
    elif kind == "ctx_every_step":
        n_ctx, tok, ctx = 13, rng.integers(0, ALPHABET, (T, lanes)), (np.arange(T) * 7) % 13
    elif kind == "every_bin":  # every (context, token) of 765 x A hit
        T = 800
        n_ctx, ctx = 765, np.arange(T) % 765
        tok = (np.arange(lanes)[None, :] + np.arange(T)[:, None]) % ALPHABET
    else:  # a skewed stream in long runs, T ragged
        n_ctx, ctx = 40, np.repeat(rng.integers(0, 40, T), 1)
        ctx = np.repeat(ctx[: -(-T // 9)], 9)[:T]
        tok = np.where(rng.random((T, lanes)) < 0.8, 0, rng.integers(0, ALPHABET, (T, lanes)))
    tokp = torch.from_numpy(np.ascontiguousarray(tok.reshape(-1), dtype=np.int32)).to(dev)
    return tokp, torch.from_numpy(ctx.astype(np.int64)).to(dev), n_ctx


@pytest.mark.parametrize("lanes", [128, 256, 512, 1024])
@pytest.mark.parametrize("kind", ["zeros_one_ctx", "all_max", "ctx_every_step", "every_bin", "runs_ragged"])
def test_h1_stepped_matches_bincount_on_adversarial_streams(dev, kind, lanes):
    """The stepped form against torch.bincount on the card: one hot bin in
    one context, every token A - 1, a context that changes every step,
    every bin of 765 x A hit, long runs; T never a multiple of a CTA's
    step range. Two launches give the same counts."""
    from jxl_tpu_torch.codec.histogram import histogram_stepped, histogram_stepped_plain

    tokp, ctx, n_ctx = _adversarial_stream(kind, lanes, dev)
    got = histogram_stepped(tokp, ctx, lanes, n_ctx)
    assert torch.equal(got, histogram_stepped_plain(tokp, ctx, lanes, n_ctx))
    assert torch.equal(got, histogram_stepped(tokp, ctx, lanes, n_ctx))
    assert int(got.sum()) == tokp.numel()
    if kind == "every_bin":
        assert bool((got > 0).all())


@pytest.mark.parametrize("nb", [1, 208, 511, 513, 190512])
@pytest.mark.parametrize("kind", ["zeros", "all_max", "every_bin"])
def test_h1_ac_matches_bincount_on_adversarial_tokens(dev, kind, nb):
    """The AC form against torch.bincount on the card: every token 0, every
    token A - 1 in one bucket, and every (position, bucket, token) hit once
    nb >= 208; tiles of 512 blocks ragged at 511 and 513, and the 12 MP
    block count. Two launches give the same counts."""
    from jxl_tpu_torch.codec.histogram import ac_counts4, ac_counts4_plain
    from jxl_tpu_torch.codec.layout import NNZ_Q
    from jxl_tpu_torch.entropy.tokens import ALPHABET

    b = np.arange(nb)[None, :, None]
    p = np.arange(63)[None, None, :]
    if kind == "zeros":
        tok, qb = np.zeros((3, nb, 63)), np.random.default_rng(nb).integers(0, NNZ_Q, (3, nb))
    elif kind == "all_max":
        tok, qb = np.full((3, nb, 63), ALPHABET - 1), np.full((3, nb), NNZ_Q - 1)
    else:
        tok = np.broadcast_to((b // NNZ_Q + p) % ALPHABET, (3, nb, 63))
        qb = np.broadcast_to(np.arange(nb) % NNZ_Q, (3, nb))
    tok_t = torch.from_numpy(np.ascontiguousarray(tok, dtype=np.int32)).to(dev)
    qb_t = torch.from_numpy(np.ascontiguousarray(qb, dtype=np.int64)).to(dev)
    got = ac_counts4(tok_t, qb_t)
    assert torch.equal(got, ac_counts4_plain(tok_t, qb_t))
    assert torch.equal(got, ac_counts4(tok_t, qb_t))
    assert int(got.sum()) == tok_t.numel()
    if kind == "every_bin" and nb >= 208:
        assert bool((got > 0).all())


H1_CONTAINERS = {  # image, distance, effort, stripes (0: encode_image), H1 launches
    "kodak d=1 e7": (_bench_image, 1.0, 7, 0, 2),
    "12mp d=1 e7": (_photo_12mp, 1.0, 7, 0, 2),
    "striped d=1 e7": (_bench_image, 1.0, 7, 3, 6),
}


@pytest.mark.parametrize("case", list(H1_CONTAINERS))
def test_h1_containers_equal_the_plain_histograms(dev, monkeypatch, case):
    """One encode with H1 and one with torch.bincount swapped in on the card
    give byte-identical containers (the tables are the same integers);
    H1 launches twice a VarDCT stream, and not at all with the swap."""
    from jxl_tpu_torch.codec import encode
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.histogram import ac_counts4_plain, histogram_stepped_plain
    from jxl_tpu_torch.codec.tiled import encode_image_striped

    make, distance, effort, stripes, launches = H1_CONTAINERS[case]
    img, cfg = make(), CodecConfig(distance=distance, effort=effort)

    def run():
        if stripes:
            return encode_image_striped(img, cfg, n_stripes=stripes, device=dev)
        return encode.encode_image(img, cfg, device=dev)

    c0 = launch_counts()
    with_h1 = run()
    assert _since(c0)["hist"] == launches
    monkeypatch.setattr(encode, "_histogram_stepped", histogram_stepped_plain)
    monkeypatch.setattr(encode, "_ac_counts4", ac_counts4_plain)
    c0 = launch_counts()
    assert run() == with_h1
    assert _since(c0)["hist"] == 0


def test_encode_trace_has_no_aten_histogram(dev):
    """Under torch.profiler one VarDCT encode on the card runs H1's two
    kernels, once each, and no kernelHistogram1D (ATen's bincount; the
    radix sort's own histogram kernel of `torch.argsort` stays)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.encode import encode_image

    img, cfg = _bench_image(), CodecConfig(distance=1.0, effort=7)
    encode_image(img, cfg, device=dev)  # warm
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        encode_image(img, cfg, device=dev)
        torch.cuda.synchronize(dev)
    names = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    assert names and not [n for n in names if "kernelHistogram1D" in n]
    assert sum("hist_stepped_kernel" in n for n in names) == 1 and sum("hist_ac_kernel" in n for n in names) == 1


# ---- D1: the 2-D DCT / IDCT kernel (csrc/dct.cu) against float64 and cuBLAS

DCT_SHAPES = [(2, 2), (4, 4), (8, 4), (4, 8), (8, 8), (16, 16), (32, 32), (64, 64), (128, 128), (256, 256)]


def _dct_view_names(n: int, m: int) -> list:
    """The views of [..., n, m] blocks that the codec's call sites build."""
    names = ["contiguous", "transposed"]
    names += {(4, 4): ["sub8_quadrants"], (2, 2): ["sub8_subdc"], (8, 4): ["sub8_halves"], (4, 8): ["sub8_halves"]}.get(
        (n, m), []
    )
    names += ["merged_tiles"] if n == m >= 8 else []
    names += ["overlay_dc"] if n == m <= 32 else []
    return names


def _dct_views(n: int, m: int, dev) -> dict:
    """name -> a float32 view [..., n, m] on `dev`, as the call sites build
    them: contiguous; the transposed storage of one; and the permuted views
    of `candidates_sub8` / `_reconstruct_sub8` (4x4 quadrants, 2x2 sub-DC,
    8x4 halves, 4x8 halves), `candidates_merged` (n x n tiles of wider
    planes) and `_overlay_merged` (k x k groups of the DC plane)."""
    g = torch.Generator().manual_seed(n * 1000 + m)
    count = max(2, 40_000 // (n * m))  # ~40k samples (2 blocks at 256)

    def randn(*shape):
        return (torch.randn(*shape, generator=g) * 64).to(dev)

    views = {"contiguous": randn(count, n, m), "transposed": randn(count, m, n).transpose(-1, -2)}
    blocks = randn(3, 7, 9, 8, 8)
    lead = blocks.shape[:-2]
    if (n, m) == (4, 4):
        views["sub8_quadrants"] = blocks.reshape(*lead, 2, 4, 2, 4).permute(0, 1, 2, 3, 5, 4, 6)
    if (n, m) == (2, 2):
        views["sub8_subdc"] = randn(3, 7, 9, 2, 2, 4, 4)[..., 0, 0]
    if (n, m) == (8, 4):
        views["sub8_halves"] = blocks.reshape(*lead, 8, 2, 4).permute(0, 1, 2, 4, 3, 5)
    if (n, m) == (4, 8):
        views["sub8_halves"] = blocks.reshape(*lead, 2, 4, 8)
    if n == m >= 8:
        gy, gx = max(1, 96 // n), max(1, 160 // n)
        region = randn(3, gy * n + 5, gx * n + 3)[:, : gy * n, : gx * n]
        views["merged_tiles"] = region.reshape(3, gy, n, gx, n).permute(0, 1, 3, 2, 4)
    if n == m <= 32:
        gy, gx = 5, 6
        dc = randn(3, gy * n + 1, gx * n + 2)[:, : gy * n, : gx * n]
        views["overlay_dc"] = dc.reshape(3, gy, n, gx, n).permute(0, 1, 3, 2, 4)
    assert sorted(views) == sorted(_dct_view_names(n, m))
    return views


def _dct_12mp(n: int, dev) -> torch.Tensor:
    """The view of a 12 MP frame's three planes (4032x3024) that the
    encoder's n x n call takes, thousands of CTAs: its 3x378x504 8x8
    blocks, their 4x4 quadrants, or its 3x47x63 64x64 tiles (the views
    `probes/kernels.py` times)."""
    g = torch.Generator().manual_seed(n)
    planes = (torch.randn(3, 3024, 4032, generator=g) * 64).to(dev)
    blocks = planes.reshape(3, 378, 8, 504, 8).permute(0, 1, 3, 2, 4)
    return {
        8: blocks,
        4: blocks.reshape(3, 378, 504, 2, 4, 2, 4).permute(0, 1, 2, 3, 5, 4, 6),
        64: planes[:, :3008].reshape(3, 47, 64, 63, 64).permute(0, 1, 3, 2, 4),
    }[n]


def _dct_cases():
    small = [(n, m, name) for n, m in DCT_SHAPES for name in _dct_view_names(n, m)]
    return small + [(n, n, "12mp") for n in (8, 4, 64)]


def _dct_f64(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    from jxl_tpu_torch.transforms.dct import _dct_matrix_np

    n, m = x.shape[-2:]
    dn = torch.from_numpy(_dct_matrix_np(n)).double()
    dm = torch.from_numpy(_dct_matrix_np(m)).double()
    xd = x.double().cpu()
    return dn.T @ xd @ dm if inverse else dn @ xd @ dm.T


def _dct_gemm(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The cuBLAS path the kernel replaced, on the same view."""
    from jxl_tpu_torch.transforms.dct import _dct_matrix_np

    n, m = x.shape[-2:]
    dn = torch.from_numpy(_dct_matrix_np(n)).to(x.device)
    dm = torch.from_numpy(_dct_matrix_np(m)).to(x.device)
    return torch.matmul(torch.matmul(dn.T, x), dm) if inverse else torch.matmul(torch.matmul(dn, x), dm.T)


def _f32_bound(n: int, m: int, x: torch.Tensor) -> float:
    """A float32 bound on the error of D_n X D_m^T: two passes of length-n
    and length-m sums, each term at most sqrt(n m) max|x| (orthonormal rows),
    u = 2^-24 a rounding, twice over."""
    return 2.0 * (n + m) * (n * m) ** 0.5 * 2.0**-24 * float(x.abs().max())


@pytest.mark.parametrize("inverse", [False, True], ids=["dct", "idct"])
@pytest.mark.parametrize("n,m,view", _dct_cases(), ids=lambda v: str(v))
def test_dct_kernel_against_float64(dev, n, m, view, inverse):
    """D1 on each view the codec passes, small and at a 12 MP frame's
    size: within the stated float32 bound of float64 D X D^T, no further
    from it than twice the cuBLAS path, the same bits from two launches,
    one launch a call (two above 64), and a contiguous [..., n, m]
    result."""
    from jxl_tpu_torch.transforms.dct import dct2d, idct2d

    x = _dct_12mp(n, dev) if view == "12mp" else _dct_views(n, m, dev)[view]
    fn = idct2d if inverse else dct2d
    n0 = launch_counts()["dct2d"]
    a = fn(x)
    b = fn(x)
    torch.cuda.synchronize()
    assert launch_counts()["dct2d"] - n0 == 2 * (2 if max(n, m) > 64 else 1)
    assert a.is_contiguous() and a.shape == x.shape and a.dtype == torch.float32
    assert torch.equal(a, b)
    want = _dct_f64(x, inverse)
    err = float((a.cpu().double() - want).abs().max())
    err_gemm = float((_dct_gemm(x, inverse).cpu().double() - want).abs().max())
    assert err <= _f32_bound(n, m, x), (err, _f32_bound(n, m, x))
    assert err <= 2.0 * err_gemm, (err, err_gemm)


@pytest.mark.parametrize("n,m", DCT_SHAPES, ids=lambda v: str(v))
def test_dct_kernel_round_trip(dev, n, m):
    """idct2d(dct2d(x)) returns x within float32 rounding, on the card."""
    from jxl_tpu_torch.transforms.dct import dct2d, idct2d

    x = _dct_views(n, m, dev)["contiguous"]
    back = idct2d(dct2d(x))
    err = float((back - x).abs().max())
    assert err <= 2.0 * _f32_bound(n, m, x), (err, _f32_bound(n, m, x))


def test_dct_kernel_refuses_what_it_does_not_take(dev):
    """float64 and a ninth dim raise before any launch; an empty view
    launches nothing."""
    from jxl_tpu_torch.transforms.dct import dct2d

    n0 = launch_counts()["dct2d"]
    with pytest.raises(ValueError, match="float32"):
        dct2d(torch.zeros(4, 8, 8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="dims"):
        dct2d(torch.zeros((1,) * 7 + (8, 8), device=dev))
    assert dct2d(torch.zeros(0, 8, 8, device=dev)).shape == (0, 8, 8)
    assert launch_counts()["dct2d"] == n0


def test_codec_dct_calls_take_the_kernel(dev, dct_calls):
    """An e7 encode and decode of the card image run every dct2d / idct2d
    call through D1: one launch a call, two for a side above 64."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.encode import encode_image

    n0 = launch_counts()["dct2d"]
    data = encode_image(_card_image(), CodecConfig(distance=1.0, effort=7), device=dev)
    decode_bytes(data, device=dev)
    torch.cuda.synchronize()
    assert dct_calls and all(cuda for cuda, _, _ in dct_calls)
    assert launch_counts()["dct2d"] - n0 == dct_calls.expected_d1()


@pytest.mark.parametrize("n,m", [(3, 5), (1, 64), (64, 1), (64, 63), (12, 20), (7, 384)], ids=str)
def test_dct_kernel_takes_any_side(dev, n, m):
    """Sides the codec does not pass (odd, 1, not a power of two, one above
    64) run through D1 too, within the float32 bound of float64. (Not held
    to twice the cuBLAS path's error: at 64 x 1 cuBLAS sums the 64 terms in
    blocks, D1 in order, and reads about half D1's error.)"""
    from jxl_tpu_torch.transforms.dct import dct2d

    g = torch.Generator().manual_seed(n * 7 + m)
    x = (torch.randn(max(2, 20_000 // (n * m)), n, m, generator=g) * 64).to(dev)
    n0 = launch_counts()["dct2d"]
    a = dct2d(x)
    torch.cuda.synchronize()
    assert launch_counts()["dct2d"] - n0 == (2 if max(n, m) > 64 else 1)
    want = _dct_f64(x, False)
    err = float((a.cpu().double() - want).abs().max())
    assert err <= _f32_bound(n, m, x)


def test_chain_probe_cycles_in_range(dev):
    """The chain probe (csrc/chain_probe.cu) launches twice and reads
    every chain's cycles per link in (0, 1e4)."""
    from jxl_tpu_torch.entropy.kernel_bounds import CHAINS, measure_chain_cycles

    c0 = launch_counts()
    chains = measure_chain_cycles(dev)
    assert list(chains) == list(CHAINS) and all(0 < v < 1e4 for v in chains.values()), chains
    assert _since(c0)["chain_probe"] == 2


# ---- the paths around the codec on the card: the 71 MP file, the CLI sweep, the mesh, serve, the tools


def test_encode_file_above_the_cap_on_card(dev, tmp_path):
    """An 8192x8704 frame (71 MP, above the single-section cap) through
    encode_file and decode_bytes_device on the card: a JXTS container of
    default_n_stripes sections, each within the cap at 1024 lanes; B3 at
    least once and B1 twice a section, B2 never; above 35 dB; the middle
    section byte-identical to encode_image of its stripe alone."""
    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import MAX_PIXELS, read_container_header
    from jxl_tpu_torch.codec.decode import decode_bytes_device
    from jxl_tpu_torch.codec.encode import encode_file, encode_image
    from jxl_tpu_torch.codec.tiled import default_n_stripes, is_striped, read_striped, stripe_widths
    from jxl_tpu_torch.core.io import write_image

    h, w = 8192, 8704
    assert h * w > MAX_PIXELS
    big = synth_kodak(h, w, seed=1)
    src, dst = str(tmp_path / "big.ppm"), str(tmp_path / "big.jxt")
    write_image(src, big)
    k, widths = default_n_stripes(h, w), stripe_widths(w, default_n_stripes(h, w))
    c0 = launch_counts()
    size = encode_file(src, dst, CodecConfig(distance=1.0, effort=7), device=dev)
    with open(dst, "rb") as f:
        data = f.read()
    out = decode_bytes_device(data, device=dev)
    n = _since(c0)
    sections = read_striped(data)[2]
    assert is_striped(data) and len(data) == size and len(sections) == k
    for sec, ws in zip(sections, widths):
        hd = read_container_header(sec)
        assert (hd.height, hd.width, hd.lanes, hd.lossless) == (h, ws, 1024, False)
    assert n["rans_encode"] >= k and n["rans_decode"] == 2 * k and n["rans_decode_batched"] == 0
    assert tuple(out.shape) == big.shape and out.dtype == torch.uint8
    err = out.double() - torch.from_numpy(big).to(dev).double()
    assert 10 * np.log10(255.0**2 / float(torch.mean(err**2))) > 35.0
    del err, out
    j = k // 2
    x0 = sum(widths[:j])
    stripe = np.ascontiguousarray(big[:, x0 : x0 + widths[j]])
    assert sections[j] == encode_image(stripe, CodecConfig(distance=1.0, effort=7, modular=False), device=dev)


def _image_set(root, names) -> str:
    """A test-image directory holding test_images/synth/<names> as set `pair`."""
    import shutil

    os.makedirs(os.path.join(root, "pair"))
    for nm in names:
        shutil.copy(os.path.join(REPO, "test_images", "synth", nm), os.path.join(root, "pair", nm))
    return str(root)


def _bench_cli(argv: list):
    """`python -m jxl_tpu_torch bench` in this process, its lines swallowed."""
    import contextlib
    import io

    from jxl_tpu_torch.cli.main import main

    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["bench", *argv]) == 0, argv
    torch.cuda.synchronize()


def _csv(path) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_ab_sweep_cli_on_card(dev, tmp_path):
    """The thesis's A/B sweep through the CLI on the card (3 images x 4
    distances, BASELINE against HOMOGENEITY_PARTITIONING at e7): every CSV
    under its schema's header with a row a point, the summary's MEAN row;
    B3 at least once a point and B2 for the grid rows; each d=1 container
    decoded on the card within 1 LSB of the CPU's decode, its battery
    columns within the bars of the CPU's battery on the card's pixels."""
    from jxl_tpu_torch.bench.csv_schema import COMPARISON_DIFF_HEADER, COMPARISON_RESULT_HEADER, IMAGE_FILE_DATA_HEADER
    from jxl_tpu_torch.bench.sweep import TIMINGS_HEADER
    from jxl_tpu_torch.codec.decode import decode_file
    from jxl_tpu_torch.core.io import read_png_rgb8
    from jxl_tpu_torch.metrics.battery import metric_battery

    names = ["synth00.png", "synth01.png", "synth03.png"]
    dists = (0.5, 1.0, 3.0, 8.0)
    strategies = ("BASELINE", "HOMOGENEITY_PARTITIONING")
    images = _image_set(tmp_path / "images", names)
    c0 = launch_counts()
    _bench_cli(["--device", str(dev), "--test-image-dir", images, "--benchmark-dir", str(tmp_path / "out"),
                "--distances", *map(str, dists), "--efforts", "7", "--strategy", strategies[0],
                "--compare-to", strategies[1]])
    n = _since(c0)
    n_pts = len(names) * len(dists)
    assert n["rans_encode"] >= 2 * n_pts and n["rans_decode_batched"] >= 2, n
    base = tmp_path / "out" / "0" / "pair"
    for strat in strategies:
        for csv_name, header, n_rows in (("results.csv", IMAGE_FILE_DATA_HEADER, len(names)),
                                         ("comparisons.csv", COMPARISON_RESULT_HEADER, n_pts),
                                         ("timings.csv", TIMINGS_HEADER, n_pts)):
            rows = _csv(base / strat / "results" / csv_name)
            assert rows[0] == header and len(rows) - 1 == n_rows, (strat, csv_name, len(rows))
    diffs, summary = _csv(base / "comparison_diffs.csv"), _csv(base / "summary.csv")
    assert diffs[0] == COMPARISON_DIFF_HEADER and len(diffs) - 1 == n_pts
    assert summary[0] == COMPARISON_DIFF_HEADER and len(summary) == 2 and summary[1][0] == "MEAN"
    comps = {r[1]: r for r in _csv(base / strategies[0] / "results" / "comparisons.csv")[1:]}
    keys = ("mse", "psnr", "ssim", "ms_ssim", "butteraugli", "butteraugli_pnorm", "ssimulacra2")
    for nm in names:
        row = comps[f"{os.path.splitext(nm)[0]}-1.0-7.jxt"]
        jxt = str(base / strategies[0] / "output" / row[1])
        card = decode_file(jxt, device=dev)
        assert np.abs(card.astype(np.int32) - decode_file(jxt, device="cpu")).max() <= 1
        orig = read_png_rgb8(os.path.join(REPO, "test_images", "synth", nm))
        _assert_within_bars(dict(zip(keys, map(float, row[10:17]))), metric_battery(orig, card, device="cpu"))


def test_legacy_sweep_cli_on_card(dev, tmp_path):
    """The legacy outputs of the CLI sweep on the card (synth02, d in
    {0, 1, 3} x e5, e7, e9, --decompress --compare-images): a
    decompressed row, PNG and diff image a point, each PNG read back equal
    to the card's decode of its container; d = 0 exact at every effort."""
    from jxl_tpu_torch.bench.sweep import DECOMPRESSION_HEADER
    from jxl_tpu_torch.codec.decode import decode_file
    from jxl_tpu_torch.core.io import read_png_rgb8

    images = _image_set(tmp_path / "images", ["synth02.png"])
    dists, efforts = (0.0, 1.0, 3.0), (5, 7, 9)
    _bench_cli(["--device", str(dev), "--test-image-dir", images, "--benchmark-dir", str(tmp_path / "out"),
                "--distances", *map(str, dists), "--efforts", *map(str, efforts), "--decompress", "--compare-images"])
    base = tmp_path / "out" / "0" / "pair" / "BASELINE"
    comps = _csv(base / "results" / "comparisons.csv")[1:]
    dec = _csv(base / "results" / "decompressed.csv")
    n_pts = len(dists) * len(efforts)
    assert len(comps) == n_pts and dec[0] == DECOMPRESSION_HEADER and len(dec) - 1 == n_pts
    assert len(os.listdir(base / "diffs")) == n_pts
    orig = read_png_rgb8(os.path.join(REPO, "test_images", "synth", "synth02.png"))
    for r in comps:
        px = decode_file(str(base / "output" / r[1]), device=dev)
        np.testing.assert_array_equal(read_png_rgb8(str(base / "decompressed" / (r[1][: -len(".jxt")] + ".png"))), px)
        if float(r[2]) == 0.0:
            assert r[11] == "inf" and float(r[10]) == 0.0, r
            np.testing.assert_array_equal(px, orig)


@pytest.mark.parametrize("path", ["grid", "epf", "bench"])
def test_mesh_on_card_slots(dev, tmp_path, path):
    """The mesh paths over slots of the one card, each against its
    sequential form: encode_grid_sharded (data=2) byte-identical to
    encode_image_grid under modular=False, B3 at least once a point;
    sharded_epf (space=4) equal to epf_apply on the bench image's d=3
    planes; `bench --mesh data=2` writing the single-device run's rows and
    containers. (The striped form: test_striped_container_on_card_matches_cpu.)"""
    from dataclasses import replace

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.core.io import read_png_rgb8
    from jxl_tpu_torch.distributed.mesh import make_mesh

    synth = os.path.join(REPO, "test_images", "synth")
    if path == "grid":
        from jxl_tpu_torch.codec.encode import encode_image_grid
        from jxl_tpu_torch.distributed.sharded import encode_grid_sharded

        names = ["synth00.png", "synth01.png", "synth02.png", "synth03.png"]
        imgs = [read_png_rgb8(os.path.join(synth, nm)) for nm in names]
        dists, cfg = (0.5, 1.0, 3.0, 8.0), CodecConfig(effort=7)
        c0 = launch_counts()
        rows = encode_grid_sharded(imgs, cfg, dists, mesh=make_mesh([dev] * 2, data=2), orig_names=names)
        assert _since(c0)["rans_encode"] >= len(imgs) * len(dists)
        for img, nm, row in zip(imgs, names, rows):
            assert row == encode_image_grid(img, replace(cfg, modular=False), dists, nm, device=dev), nm
    elif path == "epf":
        from jxl_tpu_torch.codec.container import read_container
        from jxl_tpu_torch.codec.decode import decode_stream_planes
        from jxl_tpu_torch.codec.encode import encode_image
        from jxl_tpu_torch.distributed.sharded import sharded_epf
        from jxl_tpu_torch.transforms.epf import epf_apply

        data = encode_image(_bench_image(), CodecConfig(distance=3.0, effort=7), device=dev)
        planes, eff_mul = decode_stream_planes(read_container(data), device=dev)
        assert planes.is_cuda
        got = sharded_epf(planes, eff_mul, 3.0, make_mesh([dev] * 4, space=4))
        assert torch.equal(got, epf_apply(planes, eff_mul, 3.0))
    else:
        from jxl_tpu_torch.codec.encode import _modular_candidate

        names = sorted(os.listdir(synth))
        pick = [nm for nm in names if not _modular_candidate(read_png_rgb8(os.path.join(synth, nm)), 1)][:2]
        images = _image_set(tmp_path / "images", pick)
        argv = ["--device", str(dev), "--test-image-dir", images, "--distances", "0.5", "1", "3", "--efforts", "7"]
        _bench_cli(argv + ["--benchmark-dir", str(tmp_path / "mesh"), "--mesh", "data=2"])
        _bench_cli(argv + ["--benchmark-dir", str(tmp_path / "single")])
        out = [tmp_path / run / "0" / "pair" / "BASELINE" for run in ("mesh", "single")]
        a, b = (_csv(o / "results" / "comparisons.csv") for o in out)
        assert a[0] == b[0] and sorted(a[1:]) == sorted(b[1:]) and len(a) == 1 + 3 * len(pick)
        files = sorted(os.listdir(out[1] / "output"))
        assert files == sorted(os.listdir(out[0] / "output")) and len(files) == 3 * len(pick)
        for f in files:
            assert (out[0] / "output" / f).read_bytes() == (out[1] / "output" / f).read_bytes(), f


def test_serve_on_card(dev, tmp_path, monkeypatch):
    """`serve --device cuda:0` with its warm-up: every kernel library of
    the registry mapped into the server before it prints ready; a ping
    names the card; `encode` and `decode` forwarded to it write the files
    a local run of the CLI on the card writes; shutdown removes the
    socket."""
    import subprocess
    import sys

    from jxl_tpu_torch.cli.main import main
    from jxl_tpu_torch.cli.server import try_forward
    from jxl_tpu_torch.core.io import write_image
    from jxl_tpu_torch.cuda_build import KERNEL_SOURCES

    sock = str(tmp_path / "jxl.sock")
    src = str(tmp_path / "bench.png")
    write_image(src, _bench_image())
    files = {tag: [str(tmp_path / f"{tag}.{ext}") for ext in ("jxt", "png")] for tag in ("fwd", "local")}
    env = {k: v for k, v in os.environ.items() if not k.startswith("JXL_TPU_")}
    proc = subprocess.Popen([sys.executable, "-m", "jxl_tpu_torch", "serve", "--device", str(dev), "--socket", sock],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        assert proc.stdout.readline().startswith(f"[serve] ready on {sock} (device: {dev})")
        with open(f"/proc/{proc.pid}/maps") as f:
            mapped = {os.path.basename(line.split()[-1]).split("-")[0] for line in f if line.rstrip().endswith(".so")}
        assert set(KERNEL_SOURCES) <= mapped, sorted(set(KERNEL_SOURCES) - mapped)
        assert try_forward({"cmd": "ping"}, socket_path=sock) == {"ok": True, "msg": "pong", "device": str(dev)}
        jxt, png = files["fwd"]
        for req in ({"cmd": "encode", "input": src, "output": jxt, "distance": 1.0, "effort": 7},
                    {"cmd": "decode", "input": jxt, "output": png}):
            assert try_forward(req, socket_path=sock, device=str(dev))["ok"], req
        assert try_forward({"cmd": "shutdown"}, socket_path=sock)["ok"]
        assert proc.wait(timeout=60) == 0 and not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    monkeypatch.setenv("JXL_TPU_TORCH_NO_SERVER", "1")
    jxt, png = files["local"]
    assert main(["encode", src, jxt, "--device", str(dev), "--distance", "1", "--effort", "7"]) == 0
    assert main(["decode", jxt, png, "--device", str(dev)]) == 0
    for a, b in zip(files["fwd"], files["local"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), (a, b)


TOOLS = ["profile_stages", "batch_scaling", "rd_point", "bit_breakdown", "epf_ab", "profile_startup"]


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_on_card(dev, tmp_path, tool):
    """Each measurement tool of jxl_tpu_torch/tools on the card, on the
    bench image: its container equal to encode_image's where it writes
    one, its rows positive and finite, rd_point's d=1 point on the
    quality anchor, bit_breakdown's sections adding up to the payload,
    profile_startup naming the card and loading the kernels."""
    import contextlib
    import io
    import json
    import subprocess
    import sys

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.encode import encode_image

    img = _bench_image()
    data = encode_image(img, CodecConfig(distance=1.0, effort=7), device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        if tool == "profile_stages":
            from jxl_tpu_torch.tools import profile_stages

            res = profile_stages.profile(img, dev, reps=2)
            assert res["bytes"] == data and list(res["stages"]) == list(profile_stages.STAGES)
            assert all(t["ms"] > 0 and t["busy_ms"] is not None for t in res["stages"].values())
            assert sum(t["kernels"] for t in res["stages"].values()) > 0
        elif tool == "batch_scaling":
            from jxl_tpu_torch.tools import batch_scaling

            rows = batch_scaling.scaling_rows(img, dev, batches=(1, 2), iters=2)
            assert [r[0] for r in rows] == [1, 2] and all(v > 0 for r in rows for v in r[1:])
        elif tool == "rd_point":
            from jxl_tpu_torch.tools import rd_point

            (_d, bpp, psnr), _ = rd_point.rd_points({"bench": img}, [1.0, 3.0], 7, dev)["bench"]
            assert abs(psnr - ANCHOR_PSNR_DB) <= PSNR_TOL_DB and abs(bpp - ANCHOR_BPP) <= BPP_TOL_REL * ANCHOR_BPP
        elif tool == "bit_breakdown":
            from jxl_tpu_torch.tools import bit_breakdown

            bd = bit_breakdown.breakdown(img, 1.0, 7, dev)
            sec, pay = bit_breakdown.payload_bits(bd)
            assert bd["data"] == data and abs(sec / pay - 1) <= 1e-3
        elif tool == "epf_ab":
            from jxl_tpu_torch.tools import epf_ab

            rows = epf_ab.epf_rows({"bench": img}, [1.0, 4.0], dev)
            assert len(rows) == 2 and all(r[2] > 0 and np.isfinite(r[3]) and np.isfinite(r[4]) for r in rows)
    if tool == "profile_startup":
        from jxl_tpu_torch.bench.headline import smi_line
        from jxl_tpu_torch.core.io import write_image

        png, out = str(tmp_path / "bench.png"), str(tmp_path / "bench.jxt")
        write_image(png, img)
        proc = subprocess.run(
            [sys.executable, "-m", "jxl_tpu_torch.tools.profile_startup", "--encode", png, "--device", str(dev),
             "--out", out], cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stderr[-4000:]
        marks = json.loads(proc.stdout.strip().splitlines()[-1])
        assert marks["device"] == smi_line(dev) and all(v > 0 for v in marks["phase_s"].values())
        assert "kernel_build_or_load" in marks["phase_s"]
        with open(out, "rb") as f:
            assert f.read() == data
