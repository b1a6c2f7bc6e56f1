"""Port hygiene: jxl_tpu_torch never imports jax, its copied constants (codec
tables, metric weights, CSV headers, image enums, the JXTS wrapper's) equal
the reference's, no entry point is left raising NotImplementedError, and
every entry point takes an explicit device."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jxl_tpu_torch
from jxl_tpu.bench import csv_schema as jcs
from jxl_tpu.codec import container as jct
from jxl_tpu.codec import encode as jenc
from jxl_tpu.codec import layout as jly
from jxl_tpu.codec import lossless as jll
from jxl_tpu.codec import tiled as jtl
from jxl_tpu.core import image as jim
from jxl_tpu.core import xyb as jx
from jxl_tpu.entropy import cluster as jcl
from jxl_tpu.entropy import grouped as jg
from jxl_tpu.entropy import rans as jr
from jxl_tpu.entropy import tokens as jt
from jxl_tpu.metrics import perceptual as jp
from jxl_tpu.metrics import quality as jmq
from jxl_tpu.strategy import acs as ja
from jxl_tpu.transforms import adaptive as jad
from jxl_tpu.transforms import dct as jd
from jxl_tpu.transforms import epf as je
from jxl_tpu.transforms import quant as jq

from jxl_tpu_torch.bench import csv_schema as tcs
from jxl_tpu_torch.codec import container as tct
from jxl_tpu_torch.codec import encode as tenc
from jxl_tpu_torch.codec import layout as tly
from jxl_tpu_torch.codec import lossless as tll
from jxl_tpu_torch.codec import tiled as ttl
from jxl_tpu_torch.core import image as tim
from jxl_tpu_torch.core import xyb as tx
from jxl_tpu_torch.entropy import cluster as tcl
from jxl_tpu_torch.entropy import grouped as tg
from jxl_tpu_torch.entropy import rans as tr
from jxl_tpu_torch.entropy import tokens as tt
from jxl_tpu_torch.metrics import perceptual as tp
from jxl_tpu_torch.metrics import quality as tmq
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
    assert {"jxl_tpu_torch.metrics.battery", "jxl_tpu_torch.bench.sweep", "jxl_tpu_torch.cli.main"} <= set(mods)
    assert {
        "jxl_tpu_torch.codec.tiled", "jxl_tpu_torch.codec.analysis", "jxl_tpu_torch.distributed.mesh",
        "jxl_tpu_torch.distributed.sharded", "jxl_tpu_torch.cli.server",
    } <= set(mods)
    assert {f"jxl_tpu_torch.tools.{t}" for t in TOOLS} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'jxl_tpu', 'bench', 'tools'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# the port's counterparts of tools/*.py (jxl_tpu_torch/tools/)
TOOLS = (
    "make_test_images", "profile_stages", "profile_codec", "batch_scaling", "profile_startup", "rd_point",
    "rd_tune", "rd_bound", "rd_position_corpus", "rd_position_report", "bit_breakdown", "epf_ab",
    "modular_calib", "hooka_gated_ab", "ctx_study", "nnz_study", "combo_study",
)
# positional arguments a tool's command line needs
TOOL_ARGS = {"rd_position_report": ["cur.json", "prev.json"]}


def test_tool_outputs_default_under_benchmarks():
    """Every tool that writes files defaults under benchmarks/tools/<tool>/
    (git-ignored), and no default names a file git tracks."""
    import importlib

    from jxl_tpu_torch.tools import OUT_ROOT

    writers = {}
    for name in TOOLS:
        mod = importlib.import_module(f"jxl_tpu_torch.tools.{name}")
        if hasattr(mod, "OUT"):
            writers[name] = os.path.realpath(mod.OUT)
    assert set(writers) == {
        "make_test_images", "batch_scaling", "profile_startup", "rd_position_corpus", "rd_position_report",
        "epf_ab", "modular_calib", "hooka_gated_ab",
    }
    root = os.path.realpath(REPO)
    for name, path in writers.items():
        assert path.startswith(os.path.join(root, "benchmarks", "tools", name)), (name, path)
        assert path.startswith(os.path.realpath(OUT_ROOT))
        rel = os.path.relpath(path, root)
        tracked = subprocess.run(["git", "ls-files", "--", rel], cwd=REPO, capture_output=True, text=True, timeout=60)
        ignored = subprocess.run(["git", "check-ignore", "-q", rel], cwd=REPO, timeout=60)
        assert tracked.returncode == 0 and tracked.stdout == "" and ignored.returncode == 0, (name, rel)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_on_cuda_without_a_card_raises(name, monkeypatch):
    """Asked for cuda:0 where CUDA is absent, a tool raises before any work:
    nothing carries on on the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"jxl_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([*TOOL_ARGS.get(name, []), "--device", "cuda:0"])


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port on the card, where jax is absent: no
    import of jax or jxl_tpu anywhere in it, top level or inside a function."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert {"jxl_tpu_torch.codec.encode", "jxl_tpu_torch.entropy"} <= mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "jxl_tpu")]


def test_bench_torch_imports_no_jax():
    """bench_torch.py and its module run on the card, where jax is absent: no
    import of jax, jxl_tpu or bench.py in either, and importing them leaves
    no such module loaded."""
    import ast

    for path in ("bench_torch.py", os.path.join("jxl_tpu_torch", "bench", "headline.py")):
        with open(os.path.join(REPO, path)) as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert [m for m in mods if m.startswith("jxl_tpu_torch")], path
        assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "jxl_tpu", "bench")], path
    code = (
        "import sys\n"
        "import bench_torch, jxl_tpu_torch.bench.headline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'jxl_tpu', 'bench'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize(
    "path",
    ["chip_smoke.py", "bench_torch.py", os.path.join("probes", "rans_kernels.py"), os.path.join("probes", "mesh_devices.py"),
     os.path.join("probes", "stage_table.py")],
)
def test_card_script_names_resolve(path):
    """The scripts that run only on the card import here, and every name they
    take from the port or from chip_smoke.py exists: each `from M import x`
    anywhere in the file (inside functions too), and each `alias.x` for a
    module imported as `alias`. A rename then fails here, not on the card."""
    import ast
    import importlib
    import importlib.util

    full = os.path.join(REPO, path)
    spec = importlib.util.spec_from_file_location("_card_script_" + path.replace(os.sep, "_")[:-3], full)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    with open(full) as f:
        tree = ast.parse(f.read())

    def ours(name):
        return name.split(".")[0] in ("jxl_tpu_torch", "chip_smoke")

    def has(mod, name):
        if hasattr(mod, name):
            return True
        try:
            importlib.import_module(f"{mod.__name__}.{name}")
            return True
        except ImportError:
            return False

    missing, aliases, checked = [], {}, 0
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom) and n.module and ours(n.module):
            mod = importlib.import_module(n.module)
            missing += [f"{n.module}.{a.name}" for a in n.names if not has(mod, a.name)]
            checked += len(n.names)
        elif isinstance(n, ast.Import):
            aliases.update({a.asname: importlib.import_module(a.name) for a in n.names if a.asname and ours(a.name)})
    for n in ast.walk(tree):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) and n.value.id in aliases:
            missing += [] if hasattr(aliases[n.value.id], n.attr) else [f"{n.value.id}.{n.attr}"]
            checked += 1
    assert checked > 0 and not missing, missing


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
    assert tll._mod_coefs() == jll._mod_coefs()
    assert tenc.EncoderKnobs().mod_rule == jenc._mode_rule()
    assert (tly.LL_Q, tly.LL_EDGES) == (jly.LL_Q, jly.LL_EDGES)
    assert (ttl.STRIPED_MAGIC, ttl.STRIPED_VERSION, ttl.DEFAULT_STRIPE_MP) == (
        jtl.STRIPED_MAGIC, jtl.STRIPED_VERSION, jtl.DEFAULT_STRIPE_MP,
    )
    assert (tct.MAX_DIM, tct.MAX_PIXELS, tct.MAX_LANES) == (jct.MAX_DIM, jct.MAX_PIXELS, jct.MAX_LANES)


@pytest.mark.parametrize(
    "name",
    ["_S2_SCALES", "_S2_W_SCALE", "_S2_W_CH", "_S2_W_COMP", "_S2_GAIN", "_S2_POW", "_BA_BAND_W", "_BA_ASYM",
     "_BA_MASK", "_BA_GAIN", "_BA_RESP_GAMMA", "_BA_RESP_PIVOT"],
)
def test_metric_weights_equal(name):
    """The perceptual metrics' weights: the values carried across."""
    got, want = getattr(tp, name), getattr(jp, name)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


def test_quality_constants_and_csv_headers_equal():
    assert tmq._MSSSIM_WEIGHTS == jmq._MSSSIM_WEIGHTS
    np.testing.assert_array_equal(tp._BA_ACT_W, np.asarray([30.0, 6.0, 2.0], np.float32))  # inline in the reference
    for name in ("IMAGE_FILE_DATA_HEADER", "COMPARISON_RESULT_HEADER", "COMPARISON_DIFF_HEADER"):
        assert getattr(tcs, name) == getattr(jcs, name), name
    assert tcs.ComparisonResult.NUMERIC_FIELDS == jcs.ComparisonResult.NUMERIC_FIELDS
    row = jcs.ComparisonResult(orig_image_name="a.png", comp_image_name="a-1.0-7.jxt", distance=1.0, effort=7, mse=0.5, psnr=float("inf"))
    assert tcs.ComparisonResult(**vars(row)).row() == row.row()
    assert tcs.comparison_result_from_row([str(v) for v in row.row()]) == tcs.ComparisonResult(**vars(jcs.comparison_result_from_row([str(v) for v in row.row()])))


def test_image_enums_equal():
    for enum_name in ("ColorType", "ImageFormat"):
        got, want = getattr(tim, enum_name), getattr(jim, enum_name)
        assert [(m.name, m.value) for m in got] == [(m.name, m.value) for m in want]
    for m in tim.ColorType:
        assert (m.bytes_per_pixel, m.channels) == (jim.ColorType[m.name].bytes_per_pixel, jim.ColorType[m.name].channels)
    assert {k: v.name for k, v in tim._EXT_TO_FORMAT.items()} == {k: v.name for k, v in jim._EXT_TO_FORMAT.items()}
    rec = dict(image_name="x.jxt", commit="BASELINE", test_set="s", file_path="/x.jxt", width=3, height=2, file_size=9, raw_size=18,
               jxl_orig_image_name="x.png", jxl_distance=1.0, jxl_effort=7)
    assert tim.ImageFileData(**rec, format=tim.ImageFormat.Jxt).csv_row() == jim.ImageFileData(**rec, format=jim.ImageFormat.Jxt).csv_row()


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


@pytest.mark.parametrize(
    "port,ref",
    [
        (tr.quantize_histograms, jr.quantize_histograms),
        (tr.serialize_streams, jr.serialize_streams),
        (tr.deserialize_streams, jr.deserialize_streams),
        (tq.distance_scale, jq.distance_scale),
        (tq.ac_steps_np, jq.ac_steps_np),
        (tq.dc_steps_np, jq.dc_steps_np),
    ],
    ids=lambda f: f.__name__,
)
def test_numpy_copies_are_the_reference_code(port, ref):
    """The numpy pieces the port copies are the reference's source, verbatim."""
    import inspect

    assert inspect.getsource(port) == inspect.getsource(ref)


def test_fs_helpers_are_a_copy():
    import jxl_tpu.utils.fs as jfs
    import jxl_tpu_torch.utils.fs as tfs

    with open(jfs.__file__) as a, open(tfs.__file__) as b:
        assert a.read() == b.read()


def test_native_core_builds_only_under_build():
    """The port's binding compiles native/jxt_native.cpp into build/native/
    and writes nothing into native/."""
    from jxl_tpu_torch.native import bindings

    root = os.path.realpath(REPO)
    assert os.path.realpath(bindings.SOURCE) == os.path.join(root, "native", "jxt_native.cpp")
    assert os.path.realpath(bindings.BUILD_DIR) == os.path.join(root, "build", "native")
    if not bindings.available():
        pytest.skip("needs g++ to build the native core")
    lib = bindings.build()
    assert os.path.realpath(lib.parent) == os.path.join(root, "build", "native") and lib.exists()
    # (jxl_tpu's own binding may build native/libjxt_native.so meanwhile)
    assert not [f for f in os.listdir(os.path.join(REPO, "native")) if f.startswith(lib.name.split("-")[0] + "-")]


def _probe_image():
    return make_test_image(32, 48, seed=1)


def test_modular_candidate_raises_unless_disabled():
    """Flat synthetic content is a modular candidate: the port keeps what
    jxl_tpu keeps (here the modular container, byte for byte), and with
    modular=False the VarDCT encode."""
    from jxl_tpu.codec.config import CodecConfig as JaxConfig
    from jxl_tpu.codec.encode import encode_image as jax_encode

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.encode import encode_image

    img = np.zeros((32, 48, 3), np.uint8)
    img[8:24, 8:40] = (200, 40, 90)
    data = encode_image(img, CodecConfig(distance=1.0), device="cpu")
    assert data == jax_encode(img, JaxConfig(distance=1.0))
    assert read_container(data).header.lossless
    data = encode_image(img, CodecConfig(distance=1.0, modular=False), device="cpu")
    assert not read_container(data).header.lossless
    assert decode_bytes(data, device="cpu").shape == img.shape


def test_unported_entry_points_raise():
    """Nothing is left unported behind the entry points: a JXTS container
    decodes through every one of them (a grid row that holds one decodes
    per container), a malformed one is a ValueError, and no module of the
    package raises NotImplementedError."""
    from jxl_tpu_torch.codec import decode as tdec

    img = make_test_image(32, 48, seed=3)
    data = ttl.encode_image_striped(img, tenc.CodecConfig(effort=3), n_stripes=2, device="cpu")
    assert data[:4] == b"JXTS"
    px = tdec.decode_bytes(data, device="cpu")
    assert px.shape == img.shape and np.abs(px.astype(np.int32) - img).max() < 64
    assert tdec.decode_bytes_grid_stacked([data] * 2, device="cpu") is None
    assert all(np.array_equal(t.numpy(), px) for t in tdec.decode_bytes_grid_device([data] * 2, device="cpu"))
    with pytest.raises(ValueError, match="malformed"):
        tdec.decode_bytes(b"JXTS" + b"\0" * 32, device="cpu")
    pkg = os.path.dirname(jxl_tpu_torch.__file__)
    for root, _dirs, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert "NotImplementedError" not in f.read(), os.path.join(root, name)


def test_encode_file_above_the_section_cap_raises(tmp_path, monkeypatch):
    """Above MAX_PIXELS encode_file writes the striped JXTS format, as the
    reference does, and the file decodes; the single-section entry point
    refuses such an image with a ValueError naming the striped encoder."""
    from jxl_tpu_torch.codec import encode as tenc_mod
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_file
    from jxl_tpu_torch.core.io import write_image

    img = make_test_image(32, 40, seed=4)
    src = str(tmp_path / "big.png")
    write_image(src, img)
    for mod in (tenc_mod, ttl):  # a cap below the image: two stripes, 16 and 24 px wide
        monkeypatch.setattr(mod, "MAX_PIXELS", 32 * 24)
    size = tenc_mod.encode_file(src, str(tmp_path / "big.jxt"), CodecConfig(), device="cpu")
    with pytest.raises(ValueError, match="encode_image_striped"):
        tenc_mod.encode_image(img, CodecConfig(), device="cpu")
    monkeypatch.undo()
    with open(tmp_path / "big.jxt", "rb") as f:
        data = f.read()
    assert len(data) == size and ttl.is_striped(data)
    h, w, secs = ttl.read_striped(data)
    assert (h, w) == (32, 40) and len(secs) >= 2
    px = decode_file(str(tmp_path / "big.jxt"), device="cpu")
    assert px.shape == img.shape
    assert 10.0 * np.log10(255.0**2 / np.mean((px.astype(np.float64) - img) ** 2)) > 30.0


def test_lossless_container_decode_raises():
    """The reference's d = 0 container decodes in the port to the same
    (exact) pixels as in the reference."""
    from jxl_tpu.codec.config import CodecConfig as JaxConfig
    from jxl_tpu.codec.decode import decode_bytes as jax_decode
    from jxl_tpu.codec.encode import encode_image as jax_encode

    from jxl_tpu_torch.codec.decode import decode_bytes

    img = make_test_image(16, 24, seed=2)
    data = jax_encode(img, JaxConfig(distance=0.0))
    np.testing.assert_array_equal(decode_bytes(data, device="cpu"), np.asarray(jax_decode(data)))
    np.testing.assert_array_equal(decode_bytes(data, device="cpu"), img)


def test_device_is_explicit():
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.encode import encode_image
    from jxl_tpu_torch.core.device import resolve_device

    with pytest.raises(TypeError):
        encode_image(_probe_image(), CodecConfig())  # no device argument
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
