"""The port's public surface against jxl_tpu's.

For every module of `jxl_tpu`, every public top-level name (each `def`,
`class` and assignment, read from the source by AST; for an `__init__.py`
also its re-exports) is an attribute of the module of the same path in
`jxl_tpu_torch`, or stands in LEFT_OUT with its reason. LEFT_OUT is the
whole list of what the port leaves out: an entry whose name the port now
has, or that names no public name of the reference, fails, and so does a
new name of the reference that the port lacks.
"""

import ast
import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRANSPORT = "transport: JAX platform, compile-cache and Pallas switches; the port has explicit devices and no JIT cache"
ONE_HOT = "one-hot-matmul gather, a TPU idiom; the port indexes directly"
SUBLANE = "TPU sublane-packing constant of the JAX encoder's chunked buffers; the port's buffers are unchunked"
VMEM = "TPU VMEM sizing; the CUDA kernels size their shared-memory rings at compile time and loop over exactly T steps"
FACTORY = "compiled-program / jax.sharding factory; the port's mesh places whole images on devices in order"
REASONS = (TRANSPORT, ONE_HOT, SUBLANE, VMEM, FACTORY)
RENAMED = "renamed to "

LEFT_OUT = {
    "jxl_tpu.utils.jax_setup": {name: TRANSPORT for name in ("configure_jax", "ready_get", "ready_wait", "use_pallas")},
    "jxl_tpu.transforms.dct": {"select_rows": ONE_HOT},
    "jxl_tpu.entropy.grouped": {"context_rows": ONE_HOT, "ENC_CHUNK_T": SUBLANE},
    "jxl_tpu.codec.encode": {name: SUBLANE for name in ("AC_CHUNK_B", "BLK_U32", "HIST_CHUNK", "MBLK", "WBLK")},
    "jxl_tpu.entropy.pallas_rans": {
        **{name: VMEM for name in ("fits_vmem", "rows_padded", "SUBSTEPS", "WORD_SLACK", "MANT_SLACK")},
        "decode_grouped_pallas": RENAMED + "jxl_tpu_torch.entropy.cuda_rans:decode_grouped_cuda",
        "decode_grouped_pallas_batched": RENAMED + "jxl_tpu_torch.entropy.cuda_rans:decode_grouped_batched_cuda",
    },
    "jxl_tpu.entropy.pallas_rans_enc": {
        **{name: VMEM for name in ("enc_fits_vmem", "enc_caps", "SUBSTEPS")},
        "encode_grouped_pallas": RENAMED + "jxl_tpu_torch.entropy.cuda_rans_enc:encode_grouped_cuda",
    },
    "jxl_tpu.distributed.sharded": {name: FACTORY for name in ("make_sharded_encode_step", "make_sharded_grid_step")},
    "jxl_tpu.distributed.mesh": {name: FACTORY for name in ("batch_sharding", "replicated", "local_batch_to_global")},
    # the port's default socket is per user and read at call time
    "jxl_tpu.cli.server": {"DEFAULT_SOCKET": RENAMED + "jxl_tpu_torch.cli.server:default_socket"},
}


def _reference_modules() -> list:
    mods = []
    for root, _dirs, files in os.walk(os.path.join(REPO, "jxl_tpu")):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def _source(mod: str) -> str:
    path = os.path.join(REPO, *mod.split("."))
    return path + "/__init__.py" if os.path.isdir(path) else path + ".py"


def public_names(mod: str) -> set:
    """Public top-level names of a reference module, by AST."""
    with open(_source(mod)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and _source(mod).endswith("__init__.py"):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


def _port(mod: str):
    """The port's module of the same path, or None if it has none."""
    name = "jxl_tpu_torch" + mod[len("jxl_tpu"):]
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


def _resolve(target: str):
    mod, attr = target.split(":")
    return getattr(importlib.import_module(mod), attr)


REFERENCE_MODULES = _reference_modules()


def test_reference_modules_found():
    assert {"jxl_tpu", "jxl_tpu.codec.encode", "jxl_tpu.entropy.rans", "jxl_tpu.native.bindings"} <= set(REFERENCE_MODULES)
    assert public_names("jxl_tpu.entropy") == {
        "RANS_PRECISION", "rans_encode", "rans_decode", "quantize_histograms", "tokenize", "detokenize",
        "pack_bits", "unpack_bits",
    }
    assert {"rans_encode", "DEFAULT_LANES", "RANS_L", "quantize_histograms_t"} <= public_names("jxl_tpu.entropy.rans")


@pytest.mark.parametrize("mod", REFERENCE_MODULES)
def test_public_names_have_counterparts(mod):
    """Each public name of the reference module is in the port's module or
    in LEFT_OUT; a name the port has is not in LEFT_OUT."""
    left_out = LEFT_OUT.get(mod, {})
    port = _port(mod)
    missing = sorted(n for n in public_names(mod) if port is None or not hasattr(port, n))
    assert missing == sorted(n for n in missing if n in left_out), f"{mod}: not ported and not in LEFT_OUT"
    assert sorted(left_out) == missing, f"{mod}: LEFT_OUT lists names the port has"


def test_left_out_entries_are_reasoned():
    """Every LEFT_OUT entry is a public name of its reference module, with
    one of the reasons above, or a rename whose replacement exists."""
    for mod, entries in LEFT_OUT.items():
        assert mod in REFERENCE_MODULES, mod
        assert set(entries) <= public_names(mod), mod
        for name, reason in entries.items():
            if reason.startswith(RENAMED):
                assert callable(_resolve(reason[len(RENAMED):])), (mod, name)
            else:
                assert reason in REASONS, (mod, name)
    assert sum(len(e) for e in LEFT_OUT.values()) == 29


def test_package_exports():
    """The sub-package imports of jxl_tpu work against jxl_tpu_torch."""
    from jxl_tpu_torch import CodecConfig, Strategy
    from jxl_tpu_torch.codec import CodecConfig as C2, decode_bytes, encode_image
    from jxl_tpu_torch.codec.encode import encode_image as enc
    from jxl_tpu_torch.entropy import pack_bits, quantize_histograms, rans_decode, rans_encode
    from jxl_tpu_torch.entropy.rans import rans_encode as renc

    assert CodecConfig is C2 and Strategy.BASELINE.name == "BASELINE"
    assert encode_image is enc and rans_encode is renc and callable(decode_bytes)
    assert all(callable(f) for f in (pack_bits, quantize_histograms, rans_decode))
    import jxl_tpu_torch

    with pytest.raises(AttributeError):
        jxl_tpu_torch.no_such_name  # noqa: B018
    with pytest.raises(ImportError):
        from jxl_tpu_torch.codec import no_such_name  # noqa: F401


def test_lazy_exports_load_no_torch():
    """Importing the package, its codec config and the CLI loads neither
    torch nor numpy; the lazy names resolve to the real ones."""
    code = (
        "import sys\n"
        "import jxl_tpu_torch, jxl_tpu_torch.codec, jxl_tpu_torch.cli.main\n"
        "from jxl_tpu_torch.codec.config import CodecConfig\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax'))\n"
        "assert not bad, bad\n"
        "from jxl_tpu_torch import CodecConfig as C\n"
        "assert C is CodecConfig and 'torch' not in sys.modules\n"
        "from jxl_tpu_torch.codec import encode_image\n"
        "assert 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---- the functions behind the codec's new names, against the reference ----


def test_encode_image_async_is_encode_image():
    """finalize() of encode_image_async gives encode_image's container
    byte for byte on each branch (VarDCT, the VarDCT-vs-modular pick, d = 0
    with the palette arm), and the reference's at d = 1."""
    import numpy as np

    from jxl_tpu.codec.config import CodecConfig as JaxConfig
    from jxl_tpu.codec.encode import encode_image as jax_encode
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.encode import encode_image, encode_image_async
    from tests.conftest import make_test_image

    photo = make_test_image(32, 48, seed=9)
    flat = np.zeros((32, 48, 3), np.uint8)
    flat[8:24, 8:40] = (200, 40, 90)
    for img, d in ((photo, 1.0), (flat, 1.0), (flat, 0.0), (photo, 0.0)):
        fin = encode_image_async(img, CodecConfig(distance=d), "x.png", device="cpu")
        assert callable(fin)
        assert fin() == encode_image(img, CodecConfig(distance=d), "x.png", device="cpu"), d
    assert encode_image_async(photo, CodecConfig(), device="cpu")() == jax_encode(photo, JaxConfig())


def test_tiling_helpers_match_reference():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from jxl_tpu.codec.decode import blocks_to_image as jb2i
    from jxl_tpu.codec.encode import image_to_blocks as ji2b
    from jxl_tpu_torch.codec.decode import blocks_to_image
    from jxl_tpu_torch.codec.encode import image_to_blocks

    planes = np.random.default_rng(4).normal(size=(3, 13, 21)).astype(np.float32)
    blocks = image_to_blocks(torch.from_numpy(planes), 16, 24)
    assert tuple(blocks.shape) == (3, 2, 3, 8, 8)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(ji2b(jnp.asarray(planes), 16, 24)))
    back = blocks_to_image(blocks, 13, 21)
    np.testing.assert_array_equal(back.numpy(), planes)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jb2i(jnp.asarray(blocks.numpy()), 13, 21)))
    padded = torch.from_numpy(np.pad(planes, ((0, 0), (0, 3), (0, 3)), mode="edge"))
    assert image_to_blocks(padded, 16, 24).data_ptr() == padded.data_ptr()  # a view when already padded


def test_read_header_and_fs(tmp_path):
    from jxl_tpu.codec.container import read_header as jax_read_header
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container_header, read_header
    from jxl_tpu_torch.codec.encode import encode_image
    from jxl_tpu_torch.core.io import read_image_metadata
    from jxl_tpu_torch.utils import dir_exists, exists_or_create_dir
    from tests.conftest import make_test_image

    data = encode_image(make_test_image(24, 40, seed=2), CodecConfig(distance=2.0), "a.png", device="cpu")
    path = str(tmp_path / "a.jxt")
    with open(path, "wb") as f:
        f.write(data)
    hdr = read_header(path)
    assert hdr == read_container_header(data)
    assert vars(hdr) == vars(jax_read_header(path))
    meta = read_image_metadata(path)
    assert (meta.width, meta.height, meta.jxl_orig_image_name) == (40, 24, "a.png")
    sub = str(tmp_path / "x" / "y")
    assert not dir_exists(sub)
    exists_or_create_dir(sub)
    exists_or_create_dir(sub)
    assert dir_exists(sub) and not dir_exists(path)
