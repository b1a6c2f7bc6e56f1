"""The encoder's context histograms (`jxl_tpu_torch/codec/histogram.py`) on
the CPU: a CPU tensor takes the plain count (torch.bincount), equal to an
independent numpy count and launching nothing; the CUDA wrappers hand
kernel H1 (`csrc/hist.cu`) the arguments its C entry documents, checked
against a Python reading of that contract over the same memory; and the
kernel's constants are the port's. The kernel itself runs in the card
suite (`tests/test_torch_cuda.py`)."""

import ctypes
import re

import numpy as np
import pytest
import torch

from jxl_tpu_torch.codec import encode, histogram
from jxl_tpu_torch.codec.layout import NNZ_Q
from jxl_tpu_torch.cuda_build import CSRC, launch_counts
from jxl_tpu_torch.entropy.tokens import ALPHABET

A = ALPHABET


def _stepped_case(lanes: int, T: int, n_ctx: int, seed: int):
    """A skewed token stream (most tokens 0) under runs of contexts."""
    rng = np.random.default_rng(seed)
    tok = np.where(rng.random(T * lanes) < 0.7, 0, rng.integers(0, A, T * lanes)).astype(np.int32)
    ctx = np.repeat(rng.integers(0, n_ctx, -(-T // 3)), 3)[:T].astype(np.int64)
    return tok, ctx


def _ac_case(nb: int, seed: int):
    rng = np.random.default_rng(seed)
    tok = np.where(rng.random((3, nb, 63)) < 0.8, 0, rng.integers(0, A, (3, nb, 63))).astype(np.int32)
    qb = rng.integers(0, NNZ_Q, (3, nb)).astype(np.int64)
    return tok, qb


def _stepped_numpy(tok, ctx, lanes, n_ctx):
    out = np.zeros((n_ctx, A), np.int64)
    np.add.at(out, (np.repeat(ctx, lanes), tok), 1)
    return out


def _ac_numpy(tok, qb):
    out = np.zeros((3, 63, NNZ_Q, A), np.int64)
    c, b, p = np.meshgrid(np.arange(3), np.arange(tok.shape[1]), np.arange(63), indexing="ij")
    np.add.at(out, (c, p, qb[c, b], tok), 1)
    return out


@pytest.fixture
def no_launch(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(histogram, "launch", refuse)


STEPPED = [(128, 1, 1), (128, 37, 5), (256, 19, 765), (1024, 6, 12)]


@pytest.mark.parametrize("lanes,T,n_ctx", STEPPED)
def test_cpu_stepped_takes_the_plain_count(no_launch, lanes, T, n_ctx):
    """The encoder's name routes a CPU tensor to torch.bincount: exact int64
    counts, equal to numpy's, no launch."""
    tok, ctx = _stepped_case(lanes, T, n_ctx, seed=lanes + T)
    c0 = launch_counts()
    got = encode._histogram_stepped(torch.from_numpy(tok), torch.from_numpy(ctx), lanes, n_ctx)
    assert got.dtype == torch.int64 and tuple(got.shape) == (n_ctx, A)
    np.testing.assert_array_equal(got.numpy(), _stepped_numpy(tok, ctx, lanes, n_ctx))
    assert launch_counts() == c0


@pytest.mark.parametrize("nb", [1, 96, 1000])
def test_cpu_ac_counts_take_the_plain_count(no_launch, nb):
    tok, qb = _ac_case(nb, seed=nb)
    c0 = launch_counts()
    got = encode._ac_counts4(torch.from_numpy(tok), torch.from_numpy(qb))
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, 63, NNZ_Q, A)
    np.testing.assert_array_equal(got.numpy(), _ac_numpy(tok, qb))
    assert launch_counts() == c0


def _read(ptr: int, ctype, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)) if n else np.zeros(0)


def _entry(tok, key, n_keys, group, n_rows, nb, out):
    """csrc/hist.cu's `jxl_hist`, as its comment states it, on host memory."""
    assert n_keys >= 0 and group > 0 and n_rows > 0 and nb >= 0
    t = _read(tok, ctypes.c_int32, n_keys * group).reshape(n_keys, group)
    k = _read(key, ctypes.c_int64, n_keys)
    o = np.ctypeslib.as_array((ctypes.c_int64 * (n_rows * A)).from_address(out)).reshape(n_rows, A)
    if nb == 0:
        assert group % 4 == 0 and tok % 16 == 0
        rows = np.repeat(k, group).reshape(n_keys, group)
    else:
        assert group == 63 and n_keys == 3 * nb and n_rows == 3 * 63 * NNZ_Q
        chan = np.arange(n_keys)[:, None] // nb
        rows = (chan * 63 + np.arange(63)[None, :]) * NNZ_Q + k[:, None]
    ok = (t >= 0) & (t < A) & (rows >= 0) & (rows < n_rows)
    np.add.at(o, (rows[ok], t[ok]), 1)


@pytest.fixture
def entry(monkeypatch):
    """`launch` replaced by the entry's contract on host memory; records
    each call's name and integer arguments."""
    calls = []

    def fake(name, device, tok, key, n_keys, group, n_rows, nb, out):
        calls.append((name, n_keys, group, n_rows, nb))
        _entry(tok, key, n_keys, group, n_rows, nb, out)

    monkeypatch.setattr(histogram, "launch", fake)
    return calls


@pytest.mark.parametrize("lanes,T,n_ctx", STEPPED)
def test_stepped_wrapper_passes_the_entry_its_contract(entry, lanes, T, n_ctx):
    tok, ctx = _stepped_case(lanes, T, n_ctx, seed=3 * lanes + T)
    got = histogram.histogram_stepped_cuda(torch.from_numpy(tok), torch.from_numpy(ctx), lanes, n_ctx)
    assert entry == [("hist", T, lanes, n_ctx, 0)]
    np.testing.assert_array_equal(got.numpy(), _stepped_numpy(tok, ctx, lanes, n_ctx))


@pytest.mark.parametrize("nb", [1, 513])
def test_ac_wrapper_passes_the_entry_its_contract(entry, nb):
    tok, qb = _ac_case(nb, seed=7 * nb)
    got = histogram.ac_counts4_cuda(torch.from_numpy(tok), torch.from_numpy(qb))
    assert entry == [("hist", 3 * nb, 63, 3 * 63 * NNZ_Q, nb)]
    assert tuple(got.shape) == (3, 63, NNZ_Q, A)
    np.testing.assert_array_equal(got.numpy(), _ac_numpy(tok, qb))


def test_empty_inputs_launch_nothing(entry):
    z = histogram.histogram_stepped_cuda(torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int64), 128, 3)
    a = histogram.ac_counts4_cuda(torch.zeros((3, 0, 63), dtype=torch.int32), torch.zeros((3, 0), dtype=torch.int64))
    assert entry == [] and not z.any() and not a.any() and tuple(z.shape) == (3, A)


@pytest.mark.parametrize(
    "call",
    [
        lambda: histogram.histogram_stepped_cuda(torch.zeros(256, dtype=torch.int64), torch.zeros(2, dtype=torch.int64), 128, 1),
        lambda: histogram.histogram_stepped_cuda(torch.zeros(255, dtype=torch.int32), torch.zeros(2, dtype=torch.int64), 128, 1),
        lambda: histogram.histogram_stepped_cuda(torch.zeros(6, dtype=torch.int32), torch.zeros(2, dtype=torch.int64), 3, 1),
        lambda: histogram.histogram_stepped_cuda(torch.zeros(257, dtype=torch.int32)[1:], torch.zeros(2, dtype=torch.int64), 128, 1),
        lambda: histogram.ac_counts4_cuda(torch.zeros((3, 4, 64), dtype=torch.int32), torch.zeros((3, 4), dtype=torch.int64)),
        lambda: histogram.ac_counts4_cuda(torch.zeros((3, 4, 63), dtype=torch.int32), torch.zeros((3, 4), dtype=torch.int32)),
    ],
    ids=["tok_int64", "tok_short", "lanes_3", "tok_unaligned", "ac_width", "qb_int32"],
)
def test_wrappers_refuse_what_the_kernel_does_not_take(entry, call):
    with pytest.raises(ValueError):
        call()
    assert entry == []


def test_kernel_constants_are_the_ports():
    """hist.cu's alphabet, bucket count and AC width equal the port's."""
    text = (CSRC / "hist.cu").read_text()

    def const(name):
        (v,) = re.findall(rf"constexpr int {name} = (\d+);", text)
        return int(v)

    assert (const("A"), const("NNZ_Q"), const("AC_POS")) == (ALPHABET, NNZ_Q, histogram.AC_POS) == (52, 4, 63)
