"""The stable analysis entry (jxl_tpu_torch/codec/analysis.py) against
jxl_tpu/codec/analysis.py on the same numpy-seeded image, on the CPU.

Bar: the five values, in the reference's order, equal the reference's:
tokens, bit counts, mantissas and the sorted nnz buckets bit-exact, the
params word equal (on this image tests/test_torch_encode.py finds no
decision flip between the two encoders)."""

import inspect

import numpy as np
import pytest
import torch

from jxl_tpu.codec.analysis import encode_tokens_for_analysis as jax_entry

from jxl_tpu_torch.codec.analysis import encode_tokens_for_analysis
from jxl_tpu_torch.codec.layout import token_layout

from tests.conftest import make_test_image


@pytest.mark.parametrize("effort,distance", [(3, 1.0), (5, 2.0)])
def test_analysis_entry_equals_the_reference(effort, distance):
    rgb = make_test_image(64, 96, seed=5)
    ref = jax_entry(rgb, distance, height=64, width=96, effort=effort)
    got = encode_tokens_for_analysis(rgb, distance, height=64, width=96, effort=effort, device="cpu")
    assert len(got) == len(ref) == 5
    tok, nbits, mant, params, q_sorted = got
    assert tok.shape[0] == token_layout(64, 96)["n_tokens"] and int(tok.max()) < 64
    for name, g, r in zip(("token", "nbits", "mantissa"), (tok, nbits, mant), ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert int(params) == int(ref[3])
    np.testing.assert_array_equal(q_sorted.numpy(), np.asarray(ref[4]))


def test_analysis_entry_signature_and_inputs():
    """The signature tools rely on, and a tensor input gives the array's result."""
    sig = inspect.signature(encode_tokens_for_analysis)
    assert list(sig.parameters) == ["rgb", "distance", "height", "width", "effort", "hook_a", "hook_b", "device"]
    assert sig.parameters["device"].default is inspect.Parameter.empty
    rgb = make_test_image(32, 40, seed=2)
    a = encode_tokens_for_analysis(rgb, 1.0, height=32, width=40, effort=3, device="cpu")
    b = encode_tokens_for_analysis(torch.from_numpy(rgb), 1.0, height=32, width=40, effort=3, device="cpu")
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))
    with pytest.raises(TypeError):
        encode_tokens_for_analysis(rgb, 1.0, height=32, width=40)  # no device
