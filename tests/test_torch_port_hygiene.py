"""Port hygiene: jxl_tpu_torch never imports jax, its copied constants equal
the reference's, and the parts not ported yet raise NotImplementedError
rather than computing something else."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.core import xyb as jx
from jxl_tpu.entropy import cluster as jcl
from jxl_tpu.entropy import grouped as jg
from jxl_tpu.entropy import rans as jr
from jxl_tpu.entropy import tokens as jt
from jxl_tpu.strategy import acs as ja
from jxl_tpu.transforms import adaptive as jad
from jxl_tpu.transforms import dct as jd
from jxl_tpu.transforms import epf as je
from jxl_tpu.transforms import quant as jq

from jxl_tpu_torch.core import xyb as tx
from jxl_tpu_torch.entropy import cluster as tcl
from jxl_tpu_torch.entropy import grouped as tg
from jxl_tpu_torch.entropy import rans as tr
from jxl_tpu_torch.entropy import tokens as tt
from jxl_tpu_torch.strategy import acs as ta
from jxl_tpu_torch.transforms import adaptive as tad
from jxl_tpu_torch.transforms import dct as td
from jxl_tpu_torch.transforms import epf as te
from jxl_tpu_torch.transforms import quant as tq

from tests.conftest import make_test_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Every module of the package, imported in a fresh interpreter, leaves
    no jax / jaxlib module loaded."""
    mods = [m.name for m in pkgutil.walk_packages(jxl_tpu_torch.__path__, "jxl_tpu_torch.")]
    assert "jxl_tpu_torch.codec.encode" in mods and "jxl_tpu_torch.codec.decode" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'jxl_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 256])
def test_dct_tables_equal(n):
    np.testing.assert_array_equal(td._dct_matrix_np(n), jd._dct_matrix_np(n))
    np.testing.assert_array_equal(td.zigzag_order(n, n), jd.zigzag_order(n, n))
    np.testing.assert_array_equal(td.inverse_zigzag_order(n, n), jd.inverse_zigzag_order(n, n))
    np.testing.assert_array_equal(td.zigzag_order(n, 4), jd.zigzag_order(n, 4))


def test_numpy_constants_equal():
    for name in ("OPSIN_MATRIX", "OPSIN_BIAS", "CBRT_OPSIN_BIAS", "OPSIN_MATRIX_INV"):
        np.testing.assert_array_equal(getattr(tx, name), getattr(jx, name), err_msg=name)
    np.testing.assert_array_equal(tq.CHAN_BASE, jq.CHAN_BASE)
    np.testing.assert_array_equal(tq.DC_CHAN_BASE, jq.DC_CHAN_BASE)
    assert tq.FREQ_STRENGTH == jq.FREQ_STRENGTH
    assert tq.ac_recon_bias() == jq.ac_recon_bias()
    for n, m in [(8, 8), (4, 4), (8, 4), (4, 8), (16, 16), (64, 64), (256, 256)]:
        np.testing.assert_array_equal(tq._freq_weight_np(n, m), jq._freq_weight_np(n, m))
    np.testing.assert_array_equal(tad.QF_TABLE, jad.QF_TABLE)
    assert (tad.QF_LEVELS, tad.QF_CENTER_IDX) == (jad.QF_LEVELS, jad.QF_CENTER_IDX)
    assert (tad._ACT_REF, tad._STRENGTH) == (jad._ACT_REF, jad._STRENGTH)
    assert (te._EPF_BASE, te._EPF_DISTANCE_POW) == (je._EPF_BASE, je._EPF_DISTANCE_POW)
    assert ta.MERGE_LADDER == ja.MERGE_LADDER
    assert ta.ENTROPY_MUL == ja.ENTROPY_MUL
    assert (ta.N_STRATEGIES, ta.NONZERO_BITS, ta.SQRT2) == (ja.N_STRATEGIES, ja.NONZERO_BITS, ja.SQRT2)
    for C, k in [(765, 64), (765, 32), (12, 12), (100, 64)]:
        np.testing.assert_array_equal(tcl._structural_groups(C, k), jcl._structural_groups(C, k))
    assert (tt.TOKEN_SPLIT, tt.MAX_NBITS, tt.MAX_NBYTES, tt.ALPHABET) == (
        jt.TOKEN_SPLIT, jt.MAX_NBITS, jt.MAX_NBYTES, jt.ALPHABET,
    )
    assert (tr.RANS_PRECISION, tr.RANS_M, tr.RANS_L) == (jr.RANS_PRECISION, jr.RANS_M, int(jr.RANS_L))
    assert (tg.GROUP, tg.MAX_NBYTES) == (jg.GROUP, jg.MAX_NBYTES)


@pytest.mark.parametrize("d", [0.05, 0.5, 1.0, 3.0, 14.0])
def test_step_tables_match(d):
    """Quant-step tables computed in float32 on both sides (same order of
    operations; 1 ulp of float32 allowed for pow)."""
    for n, m in [(8, 8), (4, 4), (8, 4), (4, 8), (16, 16), (64, 64)]:
        np.testing.assert_allclose(
            tq.ac_steps_t(d, n, m, device="cpu").numpy(), np.asarray(jq.ac_steps_t(d, n, m)), rtol=2e-7
        )
    np.testing.assert_allclose(tq.dc_steps_t(d, device="cpu").numpy(), np.asarray(jq.dc_steps_t(d)), rtol=2e-7)
    np.testing.assert_allclose(
        ta.sub8_step_grids(d, device="cpu").numpy(), np.asarray(ja.sub8_step_grids(d)), rtol=2e-7
    )


def _probe_image():
    return make_test_image(32, 48, seed=1)


@pytest.mark.parametrize(
    "config",
    [
        dict(distance=0.0),
        dict(distance=1.0, effort=8),
        dict(distance=1.0, effort=9),
        dict(distance=1.0, strategy="HOMOGENEITY_PARTITIONING"),
        dict(distance=1.0, strategy="COMBINED"),
    ],
)
def test_unported_encode_modes_raise(config):
    from jxl_tpu_torch.codec.config import CodecConfig, Strategy
    from jxl_tpu_torch.codec.encode import encode_image

    if "strategy" in config:
        config = dict(config, strategy=Strategy[config["strategy"]])
    with pytest.raises(NotImplementedError):
        encode_image(_probe_image(), CodecConfig(**config), device="cpu")


def test_modular_candidate_raises_unless_disabled():
    """Flat synthetic content is a modular candidate: the port raises
    instead of silently skipping the reference's modular encode; with
    modular=False the VarDCT encode runs."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.encode import encode_image

    img = np.zeros((32, 48, 3), np.uint8)
    img[8:24, 8:40] = (200, 40, 90)
    with pytest.raises(NotImplementedError):
        encode_image(img, CodecConfig(distance=1.0), device="cpu")
    data = encode_image(img, CodecConfig(distance=1.0, modular=False), device="cpu")
    assert decode_bytes(data, device="cpu").shape == img.shape


def test_unported_entry_points_raise():
    from jxl_tpu_torch.codec import decode as tdec
    from jxl_tpu_torch.codec import encode as tenc
    from jxl_tpu_torch.codec.config import CodecConfig

    with pytest.raises(NotImplementedError):
        tenc.encode_image_grid(_probe_image(), CodecConfig(), [1.0, 2.0], device="cpu")
    with pytest.raises(NotImplementedError):
        tenc.encode_images([(_probe_image(), CodecConfig(), "")], device="cpu")
    with pytest.raises(NotImplementedError):
        tdec.decode_bytes_grid_stacked([b""], device="cpu")
    with pytest.raises(NotImplementedError):
        tdec.decode_bytes(b"JXTS" + b"\0" * 32, device="cpu")


def test_lossless_container_decode_raises():
    from jxl_tpu.codec.config import CodecConfig as JaxConfig
    from jxl_tpu.codec.encode import encode_image as jax_encode

    from jxl_tpu_torch.codec.decode import decode_bytes

    data = jax_encode(make_test_image(16, 24, seed=2), JaxConfig(distance=0.0))
    with pytest.raises(NotImplementedError):
        decode_bytes(data, device="cpu")


def test_device_is_explicit():
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.encode import encode_image
    from jxl_tpu_torch.core.device import resolve_device

    with pytest.raises(TypeError):
        encode_image(_probe_image(), CodecConfig())  # no device argument
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
