"""Striped JXTS containers (jxl_tpu_torch/codec/tiled.py) against
jxl_tpu/codec/tiled.py on the same numpy-seeded images, on the CPU.

Bars: the wrapper's bytes and every reader error equal the reference's;
a striped encode gives the reference's bytes (2-4 stripes, d = 0 / 0.5 /
1 / 2, on images where the per-image encodes of the two packages agree
byte for byte); each package decodes the other's containers within 1 LSB,
seam columns included; d = 0 is exact; a mixed container has the
reference's per-section modes."""

import os

import numpy as np
import pytest
import torch

from jxl_tpu.codec import tiled as jtl
from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.codec.container import read_container_header as jax_header

from jxl_tpu_torch.cli.main import main
from jxl_tpu_torch.codec import encode as tenc_mod
from jxl_tpu_torch.codec import tiled as ttl
from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.container import read_container_header
from jxl_tpu_torch.codec.decode import (
    decode_bytes,
    decode_bytes_device,
    decode_bytes_grid_stacked,
    decode_file,
    decode_stream_planes,
)
from jxl_tpu_torch.codec.container import read_container
from jxl_tpu_torch.core.io import write_image

from tests.conftest import make_test_image
from tests.test_tiled import psnr, synth


def test_stripe_widths():
    assert ttl.stripe_widths(768, 3) == [256, 256, 256]
    assert ttl.stripe_widths(200, 2) == [96, 104]
    assert sum(ttl.stripe_widths(1000, 7)) == 1000
    assert all(w % 8 == 0 for w in ttl.stripe_widths(1000, 7)[:-1])
    for width, n in [(768, 3), (200, 2), (1000, 7), (8704, 9), (64, 8)]:
        assert ttl.stripe_widths(width, n) == jtl.stripe_widths(width, n)
    for h, w in [(512, 768), (4096, 4096), (8192, 8704), (20000, 300), (100, 100)]:
        assert ttl.default_n_stripes(h, w) == jtl.default_n_stripes(h, w)
    with pytest.raises(AssertionError):
        ttl.stripe_widths(16, 3)


def test_wrapper_roundtrip_and_errors():
    secs = [b"abc", b"defgh", b""]
    data = ttl.write_striped(64, 96, secs)
    assert data == jtl.write_striped(64, 96, secs)
    assert ttl.is_striped(data) and not ttl.is_striped(b"JXT1" + data[4:])
    assert ttl.read_striped(data) == (64, 96, secs) == jtl.read_striped(data)


def _wrapper(version=1, n=2, height=64, width=96, lens=(3, 5), body=b"abcdefgh"):
    import struct

    return struct.pack("<4sBBHII", b"JXTS", version, 0, n, height, width) + struct.pack(f"<{len(lens)}I", *lens) + body


@pytest.mark.parametrize(
    "data",
    [
        b"JXT1" + _wrapper()[4:],
        _wrapper(version=2),
        _wrapper(height=0),
        _wrapper(width=(1 << 20) + 1),
        _wrapper(n=0, lens=()),
        _wrapper(n=500),
        _wrapper()[:10],
        _wrapper()[:-1],
        _wrapper() + b"x",
        _wrapper(lens=(3, 900)),
    ],
    ids=["magic", "version", "height", "width", "no-sections", "table", "truncated-head", "truncated-section",
         "trailing", "length"],
)
def test_read_striped_errors_equal_the_reference(data):
    """Every malformed wrapper raises ValueError with the reference's words."""
    with pytest.raises(ValueError) as ref:
        jtl.read_striped(data)
    with pytest.raises(ValueError) as got:
        ttl.read_striped(data)
    assert str(got.value) == str(ref.value)
    if ttl.is_striped(data):  # the decoder's entry point reports it the same way
        with pytest.raises(ValueError, match="malformed"):
            decode_bytes(data, device="cpu")


CASES = [(96, 192, 3, 1.0, 6, 0), (64, 128, 2, 2.0, 6, 3), (48, 200, 2, 0.5, 7, 1), (40, 256, 4, 1.0, 5, 2)]


@pytest.mark.parametrize("h,w,n,d,effort,seed", CASES)
def test_striped_bytes_and_cross_decode(h, w, n, d, effort, seed):
    img = synth(h, w, seed=seed)
    got = ttl.encode_image_striped(img, CodecConfig(distance=d, effort=effort), n_stripes=n, orig_name="a.png", device="cpu")
    ref = jtl.encode_image_striped(img, JaxConfig(distance=d, effort=effort), n_stripes=n, orig_name="a.png")
    gh, gw, gsecs = ttl.read_striped(got)
    _rh, _rw, rsecs = jtl.read_striped(ref)
    assert (gh, gw, len(gsecs)) == (h, w, n) and len(rsecs) == n
    assert [read_container_header(s).orig_name for s in gsecs] == ["a.png"] + [""] * (n - 1)
    assert [read_container_header(s).width for s in gsecs] == ttl.stripe_widths(w, n)
    # each package decodes both containers; within 1 LSB of each other everywhere (seams included)
    for blob in (got, ref):
        px_t = decode_bytes(blob, device="cpu")
        px_j = np.asarray(jtl.decode_striped_bytes(blob))
        assert px_t.shape == img.shape and px_t.dtype == np.uint8
        assert np.abs(px_t.astype(np.int32) - px_j).max() <= 1
    assert got == ref  # no near-tie decision flips on these images: the reference's bytes


def test_striped_roundtrip_quality():
    """Striped encode/decode lands at the same quality as single-section,
    and every decode entry point routes a JXTS container."""
    from jxl_tpu_torch.codec.encode import encode_image

    img = synth(96, 192)
    cfg = CodecConfig(distance=1.0, effort=6)
    single = decode_bytes(encode_image(img, cfg, device="cpu"), device="cpu")
    data = ttl.encode_image_striped(img, cfg, n_stripes=3, device="cpu")
    out = ttl.decode_striped_bytes(data, device="cpu")
    assert out.shape == img.shape
    assert psnr(img, out) > 30.0 and abs(psnr(img, single) - psnr(img, out)) < 1.0
    np.testing.assert_array_equal(decode_bytes(data, device="cpu"), out)
    dev_out = decode_bytes_device(data, device="cpu")
    assert isinstance(dev_out, torch.Tensor) and dev_out.dtype == torch.uint8
    np.testing.assert_array_equal(dev_out.numpy(), out)
    assert decode_bytes_grid_stacked([data, data], device="cpu") is None  # a striped row decodes per container


def test_striped_seam_epf_uses_true_neighbors(monkeypatch):
    """The stitched EPF filters seam columns with their neighbours across
    the seam: away from it the result equals the naive paste of per-section
    decodes, at it the two differ (EPF pinned on: the encoder's measured
    decision leaves it off on this small image)."""
    monkeypatch.setenv("JXL_TPU_EPF_FORCE", "1")
    img = synth(64, 128, seed=3)
    data = ttl.encode_image_striped(img, CodecConfig(distance=2.0, effort=6), n_stripes=2, device="cpu")
    out = ttl.decode_striped_bytes(data, device="cpu")
    _h, _w, secs = ttl.read_striped(data)
    assert all(read_container_header(s).epf for s in secs)
    naive = np.concatenate([decode_bytes(s, device="cpu") for s in secs], axis=1)
    np.testing.assert_array_equal(out[:, :56], naive[:, :56])
    np.testing.assert_array_equal(out[:, 72:], naive[:, 72:])
    assert not np.array_equal(out[:, 56:72], naive[:, 56:72])
    # the planes the stitch starts from are the single-section decoder's own
    planes, eff_mul = decode_stream_planes(read_container(secs[0]), device="cpu")
    assert planes.shape == (3, 64, 64) and eff_mul.shape == (8, 8)


def test_striped_lossless():
    img = synth(40, 80, seed=5)
    data = ttl.encode_image_striped(img, CodecConfig(distance=0.0, effort=7), n_stripes=2, device="cpu")
    assert data == jtl.encode_image_striped(img, JaxConfig(distance=0.0, effort=7), n_stripes=2)
    np.testing.assert_array_equal(ttl.decode_striped_bytes(data, device="cpu"), img)
    np.testing.assert_array_equal(np.asarray(jtl.decode_striped_bytes(data)), img)


def _mixed_image():
    rng = np.random.default_rng(42)
    ui = np.full((64, 128, 3), 240, np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, 56), rng.integers(0, 100)
        ui[y : y + 6, x : x + int(rng.integers(10, 28))] = [40, 40, 90]
    return np.concatenate([ui, synth(64, 128, seed=11)], axis=1)


def test_mixed_mode_stripes_roundtrip():
    """Per-stripe VarDCT-vs-modular decisions: UI stripes code modular and
    photo stripes VarDCT in one container, with the reference's modes."""
    img = _mixed_image()
    data = ttl.encode_image_striped(img, CodecConfig(distance=1.0, effort=5), n_stripes=4, device="cpu")
    ref = jtl.encode_image_striped(img, JaxConfig(distance=1.0, effort=5), n_stripes=4)
    modes = [read_container_header(s).lossless for s in ttl.read_striped(data)[2]]
    assert any(modes) and not all(modes), modes
    assert modes == [jax_header(s).lossless for s in jtl.read_striped(ref)[2]]
    out = ttl.decode_striped_bytes(data, device="cpu")
    assert out.shape == img.shape and psnr(img, out) > 30.0
    assert np.abs(out.astype(np.int32) - np.asarray(jtl.decode_striped_bytes(data))).max() <= 1
    assert np.abs(decode_bytes(ref, device="cpu").astype(np.int32) - np.asarray(jtl.decode_striped_bytes(ref))).max() <= 1


def test_sections_disagreeing_on_distance_raise():
    from jxl_tpu_torch.codec.encode import encode_image

    img = synth(32, 64, seed=2)
    secs = [encode_image(img[:, :32], CodecConfig(distance=1.0, effort=3), device="cpu"),
            encode_image(img[:, 32:], CodecConfig(distance=2.0, effort=3), device="cpu")]
    bad = ttl.write_striped(32, 64, secs)
    with pytest.raises(ValueError, match="sections disagree on distance"):
        ttl.decode_striped_bytes(bad, device="cpu")
    with pytest.raises(ValueError, match="sections disagree on distance"):
        jtl.decode_striped_bytes(bad)


def test_stripe_count_is_raised_to_the_section_cap(monkeypatch):
    """A stripe count too small for the single-section cap is raised, as in
    the reference, so the port's own decoder accepts every section."""
    img = synth(32, 96, seed=6)
    monkeypatch.setattr(ttl, "MAX_PIXELS", 32 * 40)
    data = ttl.encode_image_striped(img, CodecConfig(distance=1.0, effort=3), n_stripes=1, device="cpu")
    monkeypatch.undo()
    _h, _w, secs = ttl.read_striped(data)
    assert len(secs) == 3 and [read_container_header(s).width for s in secs] == [32, 32, 32]
    assert not any(read_container_header(s).lossless for s in secs)
    assert psnr(img, decode_bytes(data, device="cpu")) > 30.0


def test_encode_file_above_the_cap_and_cli_stripes(tmp_path, monkeypatch, capsys):
    img = make_test_image(32, 48, seed=4)
    src = str(tmp_path / "in.png")
    write_image(src, img)
    for mod in (tenc_mod, ttl):  # a cap of half the image: two sections of 32x24
        monkeypatch.setattr(mod, "MAX_PIXELS", 32 * 24)
    big = str(tmp_path / "big.jxt")
    size = tenc_mod.encode_file(src, big, CodecConfig(effort=3), device="cpu")
    monkeypatch.undo()
    with open(big, "rb") as f:
        data = f.read()
    assert ttl.is_striped(data) and len(data) == size == os.path.getsize(big)
    assert [read_container_header(s).width for s in ttl.read_striped(data)[2]] == [24, 24]
    assert read_container_header(ttl.read_striped(data)[2][0]).orig_name == "in.png"
    assert psnr(img, decode_file(big, device="cpu")) > 30.0

    out = str(tmp_path / "s.jxt")
    assert main(["encode", src, out, "--device", "cpu", "--stripes", "2", "--effort", "3"]) == 0
    line = capsys.readouterr().out
    assert "bytes" in line and "bpp" in line
    with open(out, "rb") as f:
        data = f.read()
    assert data == ttl.encode_image_striped(img, CodecConfig(effort=3), n_stripes=2, orig_name="in.png", device="cpu")
    back = str(tmp_path / "back.png")
    assert main(["decode", out, back, "--device", "cpu"]) == 0
    from jxl_tpu_torch.core.io import read_image

    np.testing.assert_array_equal(read_image(back), decode_bytes(data, device="cpu"))
