"""The port's standalone interleaved rANS coder, mantissa packers and quant
step API against jxl_tpu's, bit for bit, on the CPU.

Token streams are made from a numpy seed with a geometric skew over
contexts that include one single-symbol context and one unused context;
the tables come from the reference's `quantize_histograms`. Streams cross
between the two packages through `serialize_streams` bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_tpu.entropy import rans as jr
from jxl_tpu.entropy import tokens as jt
from jxl_tpu.transforms import quant as jq
from jxl_tpu_torch.entropy import rans as tr
from jxl_tpu_torch.entropy import tokens as tt
from jxl_tpu_torch.transforms import quant as tq

N_CTX = 6  # context 4 codes one symbol only, context 5 is unused
SINGLE, ALPHABET = 4, 52


def stream(n: int, seed: int):
    """(tokens [n] int32, ctx [n] int32, freq, cum) with the tables of the
    reference's quantize_histograms."""
    rng = np.random.default_rng(seed)
    tokens = np.minimum(rng.geometric(0.35, n) - 1, ALPHABET - 1).astype(np.int32)
    ctx = rng.integers(0, N_CTX - 1, n).astype(np.int32)
    tokens[ctx == SINGLE] = 7
    counts = np.zeros((N_CTX, ALPHABET), np.int64)
    np.add.at(counts, (ctx, tokens), 1)
    freq, cum = jr.quantize_histograms(counts)
    return tokens, ctx, freq, cum


def jax_encode(tokens, ctx, freq, cum, lanes):
    w, nw, st = jr.rans_encode(jnp.asarray(tokens), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), lanes=lanes)
    return np.asarray(w), int(nw), np.asarray(st)


def jax_decode(words, states, ctx, freq, cum, n, lanes):
    return np.asarray(
        jr.rans_decode(jnp.asarray(words), jnp.asarray(states), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), n, lanes=lanes)
    )


def i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


CASES = [(n, lanes) for n in (1, 255, 256, 257, 5000) for lanes in (1, 4, 256)]


@pytest.mark.parametrize("n,lanes", CASES)
def test_coder_matches_reference(n, lanes):
    """Words, word count, states and stream bytes equal; each package
    decodes the other's stream, and the port its own."""
    tokens, ctx, freq, cum = stream(n, seed=n + lanes)
    wj, nj, sj = jax_encode(tokens, ctx, freq, cum, lanes)
    wt, nt, st = tr.rans_encode(tokens, ctx, freq, cum, lanes, device="cpu")
    assert wt.dtype == torch.int32 and st.dtype == torch.int64 and nt.dtype == torch.int32
    assert int(nt) == nj
    np.testing.assert_array_equal(wt.numpy(), i64(wj))
    np.testing.assert_array_equal(st.numpy(), i64(sj))
    blob = tr.serialize_streams(wt, nt)
    assert blob == jr.serialize_streams(wj, nj)

    T = max(1, -(-n // lanes))
    from_jax = tr.deserialize_streams(jr.serialize_streams(wj, nj), T * lanes)
    np.testing.assert_array_equal(tr.rans_decode(from_jax, sj, ctx, freq, cum, n, lanes, device="cpu").numpy(), tokens)
    np.testing.assert_array_equal(jax_decode(jr.deserialize_streams(blob, T * lanes), st.numpy(), ctx, freq, cum, n, lanes), tokens)
    t = [torch.from_numpy(i64(a)) for a in (ctx, freq, cum)]
    np.testing.assert_array_equal(tr.rans_decode(wt, st, *t, n, lanes).numpy(), tokens)


@pytest.mark.parametrize("keep", ["half", "none", "below_lanes"])
def test_short_stream_window_clamps(keep):
    """A words array that ends before the decoder's reads: the window start
    clamps as the reference's dynamic_slice does, so both packages decode
    the same (wrong) tokens."""
    n, lanes = 5000, 4
    tokens, ctx, freq, cum = stream(n, seed=11)
    wj, nj, sj = jax_encode(tokens, ctx, freq, cum, lanes)
    cut = {"half": nj // 2, "none": 0, "below_lanes": lanes - 1}[keep]
    short = wj[:cut]
    got = tr.rans_decode(short, sj, ctx, freq, cum, n, lanes, device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_decode(short, sj, ctx, freq, cum, n, lanes))
    assert not np.array_equal(got, tokens)


def test_out_of_range_ids_clamp():
    """Context ids past the tables read the last table entry, as the
    reference's gathers clamp."""
    n, lanes = 600, 4
    tokens, ctx, freq, cum = stream(n, seed=5)
    ctx_bad = ctx.copy()
    ctx_bad[::7] = N_CTX + 3
    wj, nj, sj = jax_encode(tokens, ctx_bad, freq, cum, lanes)
    wt, nt, st = tr.rans_encode(tokens, ctx_bad, freq, cum, lanes, device="cpu")
    assert int(nt) == nj
    np.testing.assert_array_equal(wt.numpy(), i64(wj))
    np.testing.assert_array_equal(st.numpy(), i64(sj))
    got = tr.rans_decode(wj, sj, ctx_bad, freq, cum, n, lanes, device="cpu").numpy()
    np.testing.assert_array_equal(got, jax_decode(wj, sj, ctx_bad, freq, cum, n, lanes))


def test_decode_table_with_zero_frequencies():
    """searchsorted(cum, slot, right=True) - 1 picks the last symbol whose
    cum is <= slot, as the reference's count: zero-frequency symbols at the
    front, in the middle and at the end, a single-symbol and an unused
    context."""
    counts = np.zeros((5, 9), np.int64)
    counts[0] = [0, 0, 5, 0, 0, 9, 0, 1, 0]
    counts[1] = [3, 0, 0, 0, 0, 0, 0, 0, 2]
    counts[2] = [0, 0, 0, 0, 0, 0, 0, 0, 4]
    counts[3, 4] = 17
    freq, cum = jr.quantize_histograms(counts)
    assert (freq == 0).any()
    want = i64(jr.build_decode_table(jnp.asarray(freq), jnp.asarray(cum)))
    got = tr.build_decode_table(torch.from_numpy(i64(freq)), torch.from_numpy(i64(cum)))
    np.testing.assert_array_equal(got.numpy(), want)
    _, _, f, c = stream(5000, seed=3)
    np.testing.assert_array_equal(
        tr.build_decode_table(torch.from_numpy(i64(f)), torch.from_numpy(i64(c))).numpy(),
        i64(jr.build_decode_table(jnp.asarray(f), jnp.asarray(c))),
    )
    with pytest.raises(ValueError, match="6 bits"):
        tr.build_decode_table(torch.ones((2, 65), dtype=torch.int64), torch.zeros((2, 65), dtype=torch.int64))


@pytest.mark.parametrize("alphabet", [2, 9, 52])
def test_quantize_histograms_equal(alphabet):
    rng = np.random.default_rng(alphabet)
    counts = rng.integers(0, 1000, (6, alphabet))
    counts[1] = 0  # unused
    counts[2] = 0
    counts[2, alphabet // 2] = 17  # single symbol
    counts[3] *= 1 << 30  # float64 ratio at large totals
    for a, b in zip(tr.quantize_histograms(counts), jr.quantize_histograms(counts)):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def test_inputs_need_a_device():
    tokens, ctx, freq, cum = stream(300, seed=2)
    with pytest.raises(ValueError, match="device"):
        tr.rans_encode(tokens, ctx, freq, cum, 4)
    t = [torch.from_numpy(i64(a)) for a in (tokens, ctx, freq, cum)]
    w, nw, st = tr.rans_encode(*t, lanes=4)
    assert w.device.type == "cpu"
    with pytest.raises(ValueError, match="device"):
        tr.rans_decode(w, st, ctx, freq, cum, 300, 4)


@pytest.mark.parametrize("n", [1, 255, 5000])
def test_packers_match_reference(n):
    """detokenize, the byte packer and the bit packer equal the reference's,
    also with buffers too small (drops) and words cut short (clamps)."""
    rng = np.random.default_rng(n)
    vals = np.where(rng.random(n) < 0.5, rng.integers(0, 32, n), rng.integers(0, 1 << 24, n)).astype(np.uint32)
    tok, nb, mant = jt.tokenize(jnp.asarray(vals))
    tok_t, nb_t, mant_t = (torch.from_numpy(i64(a)) for a in (tok, nb, mant))
    np.testing.assert_array_equal(tt.detokenize(tok_t, mant_t).numpy(), i64(jt.detokenize(tok, mant)))
    np.testing.assert_array_equal(tt.detokenize(tok_t, mant_t).numpy(), vals)
    np.testing.assert_array_equal(tt.nbits_to_nbytes(nb_t).numpy(), np.asarray(jt.nbits_to_nbytes(nb)))
    assert (tt.byte_capacity(n), tt.bit_capacity_words(n)) == (jt.byte_capacity(n), jt.bit_capacity_words(n))

    for cap in (jt.byte_capacity(n), max(1, int(np.asarray(jt.nbits_to_nbytes(nb)).sum()) // 2)):
        bj, totj = jt.pack_bytes(nb, mant, cap)
        bt, tot = tt.pack_bytes(nb_t, mant_t, cap)
        assert int(tot) == int(totj)
        np.testing.assert_array_equal(bt.numpy(), i64(bj))
        np.testing.assert_array_equal(tt.unpack_bytes(nb_t, bt).numpy(), i64(jt.unpack_bytes(nb, bj)))
    np.testing.assert_array_equal(tt.unpack_bytes(nb_t, tt.pack_bytes(nb_t, mant_t, tt.byte_capacity(n))[0]).numpy(), i64(mant))

    for words in (jt.bit_capacity_words(n), max(1, int(np.asarray(nb).sum()) // 64)):
        wj, bits_j = jt.pack_bits(nb, mant, words)
        wt, bits_t = tt.pack_bits(nb_t, mant_t, words)
        assert int(bits_t) == int(bits_j)
        np.testing.assert_array_equal(wt.numpy(), i64(wj))
        np.testing.assert_array_equal(tt.unpack_bits(nb_t, wt).numpy(), i64(jt.unpack_bits(nb, wj)))
    wt, _ = tt.pack_bits(nb_t, mant_t, tt.bit_capacity_words(n))
    np.testing.assert_array_equal(tt.unpack_bits(nb_t, wt).numpy(), i64(mant))


@pytest.mark.parametrize("d", [0.05, 0.5, 1.0, 3.0, 14.0])
def test_quant_api_matches_reference(d):
    """The numpy step tables are the reference's code (equal exactly); the
    tensor forms carry them; quantize rounds half to even, as jnp.round."""
    assert tq.distance_scale(d) == jq.distance_scale(d)
    np.testing.assert_array_equal(tq.dc_steps_np(d), jq.dc_steps_np(d))
    np.testing.assert_array_equal(tq.dc_steps(d, device="cpu").numpy(), np.asarray(jq.dc_steps(d)))
    for n, m in [(8, 8), (4, 8), (16, 16)]:
        np.testing.assert_array_equal(tq.ac_steps_np(d, n, m), jq.ac_steps_np(d, n, m))
        np.testing.assert_array_equal(tq.ac_steps(d, n, m, device="cpu").numpy(), np.asarray(jq.ac_steps(d, n, m)))
    steps = jq.ac_steps_np(d)
    rng = np.random.default_rng(int(d * 100))
    coeffs = (rng.normal(0, 4, (3, 8, 8)) * steps).astype(np.float32)
    coeffs[0, 0, :6] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32) * steps[0, 0, :6]  # exact ties
    qj = np.asarray(jq.quantize(jnp.asarray(coeffs), jnp.asarray(steps)))
    qt = tq.quantize(torch.from_numpy(coeffs), torch.from_numpy(steps))
    assert qt.dtype == torch.int32
    np.testing.assert_array_equal(qt.numpy(), qj)
    dt = tq.dequantize(qt, torch.from_numpy(steps))
    assert dt.dtype == torch.float32
    np.testing.assert_array_equal(dt.numpy(), np.asarray(jq.dequantize(jnp.asarray(qj), jnp.asarray(steps))))
    tq.ac_steps(d, device="cpu").zero_()  # a caller's tensor is a copy of the cached table
    np.testing.assert_array_equal(tq.ac_steps_np(d), jq.ac_steps_np(d))
