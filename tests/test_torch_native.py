"""Three-way conformance of the interleaved rANS coder and the MSB-first bit
packer: the port (jxl_tpu_torch), the native C++ core (bound by the port's
own `jxl_tpu_torch.native`) and jxl_tpu must write the same streams and
words, bit for bit, and each must decode the others'. Skips only where
g++ is missing (decided in the fixture)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jxl_tpu.entropy import rans as jr
from jxl_tpu.entropy import tokens as jt
from jxl_tpu_torch.entropy import rans as tr
from jxl_tpu_torch.entropy import tokens as tt
from jxl_tpu_torch.native import bindings


@pytest.fixture(scope="module")
def native():
    if not bindings.available():
        pytest.skip("needs g++ to build native/jxt_native.cpp")
    return bindings


def _stream(n: int, seed: int, n_ctx: int = 7):
    """Geometric-skew tokens over n_ctx contexts: context n_ctx - 2 codes a
    single symbol, context n_ctx - 1 is unused."""
    rng = np.random.default_rng(seed)
    tokens = np.minimum(rng.geometric(0.4, n) - 1, 36).astype(np.int32)
    ctx = rng.integers(0, n_ctx - 1, n).astype(np.int32)
    tokens[ctx == n_ctx - 2] = 3
    counts = np.zeros((n_ctx, 37), np.int64)
    np.add.at(counts, (ctx, tokens), 1)
    freq, cum = tr.quantize_histograms(counts)
    return tokens, ctx, freq, cum


@pytest.mark.parametrize("n,lanes", [(1, 1), (257, 4), (5000, 256), (20000, 16)])
def test_coder_three_way(native, n, lanes):
    tokens, ctx, freq, cum = _stream(n, seed=n)
    wn, nn, sn = native.rans_encode_native(tokens, ctx, freq, cum, lanes)
    wt, nt, st = tr.rans_encode(tokens, ctx, freq, cum, lanes, device="cpu")
    wj, nj, sj = jr.rans_encode(jnp.asarray(tokens), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), lanes=lanes)
    assert nn == int(nt) == int(nj)
    np.testing.assert_array_equal(sn.astype(np.int64), st.numpy())
    np.testing.assert_array_equal(sn, np.asarray(sj))
    blob = tr.serialize_streams(wt, nt)
    assert blob == jr.serialize_streams(wn, nn) == jr.serialize_streams(np.asarray(wj), int(nj))

    # each decoder reads the others' streams
    T = max(1, -(-n // lanes))
    words = tr.deserialize_streams(blob, T * lanes)
    np.testing.assert_array_equal(native.rans_decode_native(wt, nt, st, ctx, freq, cum, n, lanes), tokens)
    np.testing.assert_array_equal(native.rans_decode_native(np.asarray(wj), int(nj), np.asarray(sj), ctx, freq, cum, n, lanes), tokens)
    np.testing.assert_array_equal(tr.rans_decode(wn, sn, ctx, freq, cum, n, lanes, device="cpu").numpy(), tokens)
    dj = jr.rans_decode(jnp.asarray(words), jnp.asarray(sn), jnp.asarray(ctx), jnp.asarray(freq), jnp.asarray(cum), n, lanes=lanes)
    np.testing.assert_array_equal(np.asarray(dj), tokens)


@pytest.mark.parametrize("n", [1, 5000])
def test_bitpack_three_way(native, n):
    rng = np.random.default_rng(n + 3)
    vals = rng.integers(0, 1 << 18, n).astype(np.uint32)
    tok, nbits, mant = tt.tokenize(torch.from_numpy(vals.astype(np.int64)))
    cap = tt.bit_capacity_words(n)
    wt, _bits = tt.pack_bits(nbits, mant, cap)
    wn = native.pack_bits_native(nbits, mant, cap)
    wj, _ = jt.pack_bits(jnp.asarray(nbits.numpy()), jnp.asarray(mant.numpy().astype(np.uint32)), cap)
    np.testing.assert_array_equal(wt.numpy(), wn.astype(np.int64))
    np.testing.assert_array_equal(wn, np.asarray(wj))
    for words in (wn, wt.numpy(), np.asarray(wj)):
        np.testing.assert_array_equal(tt.unpack_bits(nbits, torch.from_numpy(words.astype(np.int64))).numpy(), mant.numpy())
        np.testing.assert_array_equal(native.unpack_bits_native(nbits, words).astype(np.int64), mant.numpy())
        np.testing.assert_array_equal(np.asarray(jt.unpack_bits(jnp.asarray(nbits.numpy()), jnp.asarray(words.astype(np.uint32)))), mant.numpy())


def test_native_validates_before_the_call(native):
    """Sizes and ids are checked in Python: the C core indexes unchecked."""
    tokens, ctx, freq, cum = _stream(300, seed=1)
    with pytest.raises(ValueError, match="outside"):
        native.rans_encode_native(tokens, ctx + 7, freq, cum, 4)
    with pytest.raises(ValueError, match="frequency 0"):
        native.rans_encode_native(np.full(300, 36, np.int32), ctx, freq, cum, 4)
    w, nw, st = native.rans_encode_native(tokens, ctx, freq, cum, 4)
    with pytest.raises(ValueError, match="n_words"):
        native.rans_decode_native(w[: nw - 1], nw, st, ctx, freq, cum, 300, 4)
    with pytest.raises(RuntimeError, match="rc -1"):
        native.rans_decode_native(w, nw - 1, st, ctx, freq, cum, 300, 4)
    with pytest.raises(ValueError, match="do not fit"):
        native.pack_bits_native(np.full(40, 24, np.int32), np.zeros(40, np.uint32), 29)
    with pytest.raises(ValueError, match="do not fit"):
        native.unpack_bits_native(np.full(40, 24, np.int32), np.zeros(29, np.uint32))


def test_build_failure_raises_with_the_compiler_output(native, tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; no library
    is left behind, and nothing stands in for it."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int rans_encode( { }\n")
    monkeypatch.setattr(bindings, "SOURCE", bad)
    monkeypatch.setattr(bindings, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*bad.cpp") as err:
        bindings.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(bindings.shutil, "which", lambda name: None)
    assert not bindings.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        bindings.build()
