"""The port's image I/O (jxl_tpu_torch/core/io.py): the standard-library PNG
reader against PIL, the PNG writer read back through PIL, and the
metadata records against jxl_tpu's."""

import glob
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from jxl_tpu_torch.core import io as tio

from tests.conftest import make_test_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = sorted(glob.glob(os.path.join(REPO, "test_images", "synth", "*.png")))


def _pil_rgb(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("path", SYNTH, ids=[os.path.basename(p) for p in SYNTH])
def test_reader_equals_pil_on_test_images(path):
    np.testing.assert_array_equal(tio.read_png_rgb8(path), _pil_rgb(path))


def _pil_image(mode: str, h: int = 19, w: int = 23, colours: int = 200) -> Image.Image:
    rng = np.random.default_rng(len(mode) * 31 + colours)
    rgb = make_test_image(h, w, seed=3)
    if mode == "RGB":
        return Image.fromarray(rgb)
    if mode == "RGBA":
        return Image.fromarray(np.concatenate([rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], axis=2))
    if mode == "L":
        return Image.fromarray(rgb[..., 1])
    if mode == "LA":
        return Image.fromarray(np.stack([rgb[..., 0], rng.integers(0, 256, (h, w), dtype=np.uint8)], axis=2), "LA")
    if mode == "P":
        im = Image.fromarray(rng.integers(0, colours, (h, w), dtype=np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * colours, dtype=np.uint8).tolist())
        return im
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w), dtype=np.uint8) * 255).convert("1")
    raise ValueError(mode)


@pytest.mark.parametrize("mode,ctype", [("L", 0), ("RGB", 2), ("P", 3), ("LA", 4), ("RGBA", 6)])
def test_reader_equals_pil_per_colour_type(tmp_path, mode, ctype):
    path = str(tmp_path / f"{mode}.png")
    _pil_image(mode).save(path)
    with open(path, "rb") as f:
        ihdr = struct.unpack(">IIBBBBB", f.read(29)[16:29])
    assert (ihdr[2], ihdr[3]) == (8, ctype)
    np.testing.assert_array_equal(tio.read_png_rgb8(path), _pil_rgb(path))


@pytest.mark.parametrize("mode,colours,depth", [("P", 3, 2), ("P", 12, 4), ("P", 2, 1), ("1", 0, 1)])
def test_sub_byte_pngs_go_through_pil(tmp_path, monkeypatch, mode, colours, depth):
    """1/2/4-bit PNGs (PIL writes small palettes that way) are not read by
    the stdlib reader: read_image hands them to PIL, and without PIL they
    raise ValueError."""
    path = str(tmp_path / f"{mode}{colours}.png")
    _pil_image(mode, colours=colours or 200).save(path)
    with open(path, "rb") as f:
        assert f.read(29)[24] == depth
    with pytest.raises(ValueError, match="bit depth"):
        tio.read_png_rgb8(path)
    np.testing.assert_array_equal(tio.read_image(path), _pil_rgb(path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="PIL"):
        tio.read_image(path)


def _filtered_png(path: str, rgb: np.ndarray, filters) -> None:
    """An 8-bit RGB PNG whose row y is written with filter filters[y]."""
    h, w, _ = rgb.shape
    x = rgb.reshape(h, 3 * w).astype(np.int32)
    out = []
    for y in range(h):
        f = int(filters[y])
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(3, np.int32), cur[:-3]])
        ul = np.concatenate([np.zeros(3, np.int32), up[:-3]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(tio._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fh.write(tio._png_chunk(b"IDAT", zlib.compress(b"".join(out))))
        fh.write(tio._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_reader_undoes_each_row_filter(tmp_path, filt):
    rgb = make_test_image(21, 34, seed=9)
    rgb[5:9] = np.random.default_rng(1).integers(0, 256, (4, 34, 3), dtype=np.uint8)  # wrap-around residuals
    filters = np.random.default_rng(2).integers(0, 5, 21) if filt == "mixed" else [filt] * 21
    path = str(tmp_path / f"f{filt}.png")
    _filtered_png(path, rgb, filters)
    np.testing.assert_array_equal(_pil_rgb(path), rgb)
    np.testing.assert_array_equal(tio.read_png_rgb8(path), rgb)


@pytest.mark.parametrize("shape", [(1, 1), (17, 29), (64, 96)])
def test_writer_reads_back_through_pil(tmp_path, shape):
    rgb = np.random.default_rng(shape[0]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    path = str(tmp_path / "w.png")
    tio.write_image(path, rgb)
    np.testing.assert_array_equal(_pil_rgb(path), rgb)
    np.testing.assert_array_equal(tio.read_image(path), rgb)


def test_ppm_round_trip(tmp_path):
    rgb = make_test_image(13, 17, seed=4)
    path = str(tmp_path / "x.ppm")
    tio.write_image(path, rgb)
    np.testing.assert_array_equal(tio.read_image(path), rgb)


def test_other_formats_need_pil(tmp_path, monkeypatch):
    rgb = make_test_image(8, 8, seed=1)
    path = str(tmp_path / "x.bmp")
    Image.fromarray(rgb).save(path)
    np.testing.assert_array_equal(tio.read_image(path), rgb)
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a machine without Pillow
    with pytest.raises(ValueError, match="PIL"):
        tio.read_image(path)
    with pytest.raises(ValueError, match="PIL"):
        tio.write_image(str(tmp_path / "y.bmp"), rgb)
    tio.write_image(str(tmp_path / "y.png"), rgb)  # PNG needs no library
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "y.png")), rgb)


def test_metadata_equals_reference(tmp_path):
    """13-column rows of a PNG and of a port-written .jxt equal jxl_tpu's
    (the .jxt's distance, effort and original name come from its header)."""
    from jxl_tpu.core.io import read_image_metadata as ref_meta

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.encode import encode_file

    png = str(tmp_path / "im.png")
    tio.write_image(png, make_test_image(24, 40, seed=2))
    assert tio.read_image_metadata(png, "set", "BASELINE").csv_row() == ref_meta(png, "set", "BASELINE").csv_row()
    jxt = str(tmp_path / "im.jxt")
    encode_file(png, jxt, CodecConfig(distance=1.5, effort=6), device="cpu")
    assert tio.read_image_metadata(jxt, "set").csv_row() == ref_meta(jxt, "set").csv_row()
    with pytest.raises(ValueError):
        tio.read_image(jxt)  # decoding needs an explicit device
    assert tio.read_image(jxt, device="cpu").shape == (24, 40, 3)
