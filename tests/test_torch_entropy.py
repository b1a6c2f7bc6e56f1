"""Port parity: the entropy layer of jxl_tpu_torch against jxl_tpu.

Bit-exact on every output. The Pallas kernels run in interpret mode on the
CPU (as tests/test_pallas_enc.py runs them); the port's kernel wrappers
take CPU tensors, so they run their plain torch versions here. The CUDA
kernels themselves are compared with the same plain versions on the card
by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jxl_tpu.entropy import grouped as jg
from jxl_tpu.entropy import rans as jr
from jxl_tpu.entropy import tokens as jt
from jxl_tpu.entropy.pallas_rans import MANT_SLACK, WORD_SLACK, decode_grouped_pallas, rows_padded
from jxl_tpu.entropy.pallas_rans_enc import enc_caps as jax_enc_caps
from jxl_tpu.entropy.pallas_rans_enc import encode_grouped_pallas

from jxl_tpu_torch.entropy import rans as tr
from jxl_tpu_torch.entropy import tokens as tt
from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_cuda
from jxl_tpu_torch.entropy.cuda_rans_enc import (
    enc_caps,
    encode_grouped_cuda,
    encode_grouped_plain,
)

from tests.test_pallas_enc import _stream
from tests.torch_parity import (
    carry_from_jax,
    front_pack,
    np_,
    stream_from_jax,
    t32,
    values_from_tokens,
)

LANES = [128, 256]


@pytest.fixture(scope="module", params=LANES)
def case(request):
    """One `_stream` case per lane count, encoded once by the Pallas kernel
    (interpret mode) and once by the port."""
    lanes = request.param
    n = lanes * 96
    token, nbits, mant, step_ctx, freq, cum = _stream(n, lanes, seed=3)
    T = n // lanes
    rows_j = rows_padded(jg.kernel_rows(step_ctx, freq, cum), T)
    capw, capm = jax_enc_caps(T, lanes)
    pallas = [
        np.asarray(a)
        for a in encode_grouped_pallas(
            token, mant, rows_j, T=T, lanes=lanes, capw=capw, capm=capm, interpret=True
        )
    ]
    tokp, mantp, rows = stream_from_jax(token, mant, step_ctx, freq, cum)
    port = encode_grouped_plain(tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm)
    return dict(
        lanes=lanes, T=T, capw=capw, capm=capm, token=token, nbits=nbits, mant=mant,
        step_ctx=step_ctx, freq=freq, cum=cum, rows_j=rows_j, pallas=pallas,
        tokp=tokp, mantp=mantp, rows=rows, port=port,
    )


def test_enc_caps_match(case):
    assert enc_caps(case["T"], case["lanes"]) == jax_enc_caps(case["T"], case["lanes"])


def test_tokenize_matches(case):
    vals = values_from_tokens(case["token"], case["nbits"], case["mant"])
    tok, nb, mt = tt.tokenize(torch.from_numpy(vals))
    np.testing.assert_array_equal(np_(tok), np.asarray(case["token"]))
    np.testing.assert_array_equal(np_(nb), np.asarray(case["nbits"]))
    np.testing.assert_array_equal(np_(mt), np.asarray(case["mant"]).astype(np.int64))
    signed = np.random.default_rng(5).integers(-5000, 5000, 4096)
    zz = tt.zigzag_map(torch.from_numpy(signed))
    np.testing.assert_array_equal(np_(zz), np.asarray(jt.zigzag_map(jnp.asarray(signed))))
    np.testing.assert_array_equal(np_(tt.zigzag_unmap(zz)), signed)


def test_quantize_histograms_matches(case):
    lanes = case["lanes"]
    tok = np.asarray(case["token"])
    ctx = np.repeat(np.asarray(case["step_ctx"]), lanes)
    counts = np.zeros((6, tt.ALPHABET), np.int64)
    np.add.at(counts, (ctx, tok), 1)
    counts[4] = 0  # unused context
    counts[5, 7] = 10_000_000  # single-symbol context, counts past 2^19
    f_j, c_j = jr.quantize_histograms_t(jnp.asarray(counts, jnp.int32))
    f_t, c_t = tr.quantize_histograms_t(torch.from_numpy(counts))
    np.testing.assert_array_equal(np_(f_t), np.asarray(f_j).astype(np.int64))
    np.testing.assert_array_equal(np_(c_t), np.asarray(c_j).astype(np.int64))


def test_kernel_rows_match(case):
    T = case["T"]
    np.testing.assert_array_equal(np_(case["rows"]), np.asarray(case["rows_j"])[:T])


def test_encode_plain_matches_pallas_and_xla(case):
    lanes, T, capw, capm = case["lanes"], case["T"], case["capw"], case["capm"]
    words, mbytes, states, wcounts, mcounts = (np_(a) for a in case["port"])
    wk, mk, st_k, wc_k, mc_k = case["pallas"]
    np.testing.assert_array_equal(wcounts, wc_k)
    np.testing.assert_array_equal(mcounts, mc_k)
    np.testing.assert_array_equal(states, st_k.astype(np.int64))
    G = lanes // 128
    for g in range(G):
        np.testing.assert_array_equal(words[g, capw - wcounts[g] :], wk[g, capw - wcounts[g] :])
        np.testing.assert_array_equal(mbytes[g, capm - mcounts[g] :], mk[g, capm - mcounts[g] :])

    # the XLA twins write the same streams as concatenated segments
    words_x, wc_x, st_x = (
        np.asarray(a)
        for a in jg.rans_encode_grouped(
            case["token"], case["step_ctx"], case["freq"], case["cum"], lanes
        )
    )
    mb_x, mc_x = (
        np.asarray(a)
        for a in jg.pack_mantissa_grouped(case["nbits"], case["mant"], lanes, 3 * T * lanes)
    )
    np.testing.assert_array_equal(wcounts, wc_x)
    np.testing.assert_array_equal(mcounts, mc_x)
    np.testing.assert_array_equal(states, st_x.astype(np.int64))
    wb = np.concatenate([[0], np.cumsum(wc_x)])
    mb = np.concatenate([[0], np.cumsum(mc_x)])
    for g in range(G):
        np.testing.assert_array_equal(words[g, capw - wcounts[g] :], words_x[wb[g] : wb[g + 1]])
        np.testing.assert_array_equal(mbytes[g, capm - mcounts[g] :], mb_x[mb[g] : mb[g + 1]])


def test_decode_plain_matches_pallas_two_phase(case):
    """Two decode phases joined by the carry, as the codec's v8 decode runs
    them: values, final states and stream pointers after each phase."""
    lanes, T = case["lanes"], case["T"]
    G = lanes // 128
    words, mbytes, states, wcounts, mcounts = (np_(a) for a in case["port"])
    wg = front_pack(words, wcounts, int(wcounts.max()) + WORD_SLACK)
    mg = front_pack(mbytes, mcounts, int(mcounts.max()) + MANT_SLACK)
    t_a = 40
    rows_j = np.asarray(case["rows_j"])
    va_j, st_j, p_j = decode_grouped_pallas(
        jnp.asarray(wg), jnp.asarray(mg), jnp.asarray(states.astype(np.uint32)),
        rows_padded(jnp.asarray(rows_j[:t_a]), t_a), T=t_a, lanes=lanes,
        interpret=True, return_carry=True,
    )
    vb_j, stb_j, pb_j = decode_grouped_pallas(
        jnp.asarray(wg), jnp.asarray(mg), st_j,
        rows_padded(jnp.asarray(rows_j[t_a:T]), T - t_a), T=T - t_a, lanes=lanes,
        interpret=True, ptr_init=p_j, return_carry=True,
    )

    rows = case["rows"]
    va, st_a, p_a = decode_grouped_cuda(
        t32(wg), t32(mg), case["port"][2], rows[:t_a].contiguous(),
        torch.zeros((2, G), dtype=torch.int32), T=t_a, lanes=lanes,
    )
    st_a_j, p_a_j = carry_from_jax(st_j, p_j, G)
    np.testing.assert_array_equal(np_(va), np.asarray(va_j).astype(np.int64))
    np.testing.assert_array_equal(np_(st_a), np_(st_a_j))
    np.testing.assert_array_equal(np_(p_a), np_(p_a_j))

    vb, st_b, p_b = decode_grouped_cuda(
        t32(wg), t32(mg), st_a, rows[t_a:T].contiguous(), p_a, T=T - t_a, lanes=lanes
    )
    st_b_j, p_b_j = carry_from_jax(stb_j, pb_j, G)
    np.testing.assert_array_equal(np_(vb), np.asarray(vb_j).astype(np.int64))
    np.testing.assert_array_equal(np_(st_b), np_(st_b_j))
    np.testing.assert_array_equal(np_(p_b), np_(p_b_j))
    # the whole stream decodes back to the encoded values, and the final
    # pointers have consumed exactly the encoded words and bytes
    vals = values_from_tokens(case["token"], case["nbits"], case["mant"])
    np.testing.assert_array_equal(np.concatenate([np_(va), np_(vb)]), vals)
    np.testing.assert_array_equal(np_(p_b), np.stack([wcounts, mcounts]))


def test_port_roundtrip(case):
    """The port's encode wrapper through the port's decode wrapper."""
    lanes, T, capw, capm = case["lanes"], case["T"], case["capw"], case["capm"]
    words, mbytes, states, wcounts, mcounts = encode_grouped_cuda(
        case["tokp"], case["mantp"], case["rows"], T=T, lanes=lanes, capw=capw, capm=capm
    )
    wg = front_pack(np_(words), np_(wcounts), int(wcounts.max()))
    mg = front_pack(np_(mbytes), np_(mcounts), int(mcounts.max()))
    vals, _st, ptrs = decode_grouped_cuda(
        t32(wg), t32(mg), states, case["rows"],
        torch.zeros((2, lanes // 128), dtype=torch.int32), T=T, lanes=lanes,
    )
    expect = values_from_tokens(case["token"], case["nbits"], case["mant"])
    np.testing.assert_array_equal(np_(vals), expect)
    np.testing.assert_array_equal(np_(ptrs), np.stack([np_(wcounts), np_(mcounts)]))


def test_mantissa_overflow_reports_counts(case):
    """A mantissa bucket too small for the stream: the plain kernel twin
    reports counts past the cap and keeps the stream's tail, writing
    nothing else; the wrapper re-runs with grown caps."""
    lanes, T, capw = case["lanes"], case["T"], case["capw"]
    full = case["port"]
    capm = 128
    words, mbytes, states, wcounts, mcounts = encode_grouped_plain(
        case["tokp"], case["mantp"], case["rows"], T=T, lanes=lanes, capw=capw, capm=capm
    )
    mc_full = np_(full[4])
    assert (np_(mcounts) == mc_full).all() and (mc_full > capm).all()
    for g in range(lanes // 128):
        np.testing.assert_array_equal(np_(mbytes[g]), np_(full[1][g, -capm:]))
    np.testing.assert_array_equal(np_(words), np_(full[0]))
    np.testing.assert_array_equal(np_(states), np_(full[2]))

    grown = encode_grouped_cuda(
        case["tokp"], case["mantp"], case["rows"], T=T, lanes=lanes, capw=capw, capm=capm
    )
    assert grown[1].shape[1] >= int(mc_full.max())
    for g in range(lanes // 128):
        mc = int(mc_full[g])
        np.testing.assert_array_equal(np_(grown[1][g, -mc:]), np_(full[1][g, -mc:]))


def test_wrappers_reject_bad_inputs(case):
    lanes, T = case["lanes"], case["T"]
    with pytest.raises(ValueError):
        encode_grouped_cuda(
            case["tokp"].to(torch.int64), case["mantp"], case["rows"],
            T=T, lanes=lanes, capw=case["capw"], capm=case["capm"],
        )
    bad = case["tokp"].clone()
    bad[5] = 64  # would index past the step's 64-entry freq row
    with pytest.raises(ValueError):
        encode_grouped_cuda(
            bad, case["mantp"], case["rows"], T=T, lanes=lanes, capw=case["capw"], capm=case["capm"]
        )
    with pytest.raises(ValueError):
        decode_grouped_cuda(
            torch.zeros((lanes // 128, 8), dtype=torch.int32),
            torch.zeros((lanes // 128, 8), dtype=torch.int32),
            torch.zeros(lanes, dtype=torch.int64), case["rows"][:, :64],
            torch.zeros((2, lanes // 128), dtype=torch.int32), T=T, lanes=lanes,
        )


@pytest.mark.parametrize("no_greedy", [False, True], ids=["greedy", "no_greedy"])
def test_cluster_no_greedy_knob_matches_reference(no_greedy, monkeypatch):
    """JXL_TPU_CLUSTER_NO_GREEDY (the reference's diagnostic: the k-means
    clustering returns its Lloyd assignment without the greedy merge) is
    honoured by the port: a 64x96 e7 encode under the knob, and without
    it, matches jxl_tpu's within the container bars (bytes 0.5%, PSNR
    0.02 dB); the knob changes the port's container."""
    import jax

    from jxl_tpu.codec.config import CodecConfig as JaxConfig
    from jxl_tpu.codec.decode import decode_bytes as jax_decode
    from jxl_tpu.codec.encode import encode_image as jax_encode

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.encode import encode_image

    from tests.conftest import make_test_image

    def psnr(a, b):
        d = a.astype(np.float64) - b.astype(np.float64)
        return 10 * np.log10(255.0**2 / np.mean(d * d))

    img = make_test_image(64, 96, seed=11)
    monkeypatch.delenv("JXL_TPU_CLUSTER_NO_GREEDY", raising=False)
    greedy_data = encode_image(img, CodecConfig(distance=1.0, effort=7), device="cpu")
    if no_greedy:
        monkeypatch.setenv("JXL_TPU_CLUSTER_NO_GREEDY", "1")
    # the reference reads the knob while tracing: drop its traced programs
    # before, and after (later tests of this process encode without the knob)
    jax.clear_caches()
    try:
        ref = jax_encode(img, JaxConfig(distance=1.0, effort=7))
        got = encode_image(img, CodecConfig(distance=1.0, effort=7), device="cpu")
    finally:
        monkeypatch.delenv("JXL_TPU_CLUSTER_NO_GREEDY", raising=False)
        jax.clear_caches()
    assert (got != greedy_data) == no_greedy
    assert abs(len(got) / len(ref) - 1.0) <= 0.005
    assert abs(psnr(img, decode_bytes(got, device="cpu")) - psnr(img, np.asarray(jax_decode(ref)))) <= 0.02
