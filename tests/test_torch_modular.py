"""Port parity: the modular family of jxl_tpu_torch (d = 0 lossless,
modular-lossy, palette, the VarDCT-vs-modular pick) against jxl_tpu, on
the CPU. The family is integer end to end, so the bars are exact:

- `lossless_tokens` outputs, `modular_steps`, the greedy
  `cluster_histograms` and `reconstruct_lossless` equal the reference's;
- d = 0, palette and modular-lossy containers are byte-identical to the
  reference's, and d = 0 pixels exact;
- each implementation decodes the other's modular containers exactly;
- the mode pick keeps what the reference keeps;
- a uniform modular row decodes through the batched path (kernel B2's
  plain version here) to the per-stream pixels and the reference's.

Inputs: the reference's fixtures (`synth_graphics`, `glyph_image`,
`make_test_image`) at 96x128, plus an odd 37x53 size.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jxl_tpu.bench.sweep import LEGACY_DISTANCES, RUST_DISTANCES
from jxl_tpu.codec import decode as jdec
from jxl_tpu.codec import encode as jenc
from jxl_tpu.codec import lossless as jll
from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.entropy import cluster as jcl

from jxl_tpu_torch.codec import decode as td
from jxl_tpu_torch.codec import encode as te
from jxl_tpu_torch.codec import lossless as tll
from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.container import read_container
from jxl_tpu_torch.codec.layout import lossless_layout
from jxl_tpu_torch.entropy import cluster as tcl
from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_batched_cuda, decode_grouped_cuda

from tests.conftest import make_test_image
from tests.test_modular import synth_graphics
from tests.test_palette import glyph_image
from tests.torch_parity import np_

IMAGES = {
    "graphics": lambda: synth_graphics(),
    "glyphs": lambda: glyph_image(),
    "photo_odd": lambda: make_test_image(37, 53, seed=3),
}


def _knobs():
    return te.encoder_knobs()


def _port_modular(img, d):
    return te._modular_async(torch.from_numpy(img), CodecConfig(distance=d), "", _knobs())()


def _jax_pixels(data) -> np.ndarray:
    return np.asarray(jdec.decode_bytes(data))


# ---- the integer building blocks


@pytest.mark.parametrize("name", ["graphics", "photo_odd"])
@pytest.mark.parametrize("d", [None, 0.0, 0.5, 1.0, 3.0])
def test_lossless_tokens_exact(name, d):
    img = IMAGES[name]()
    h, w = img.shape[:2]
    ref = jll.lossless_tokens(jnp.asarray(img), height=h, width=w, distance=None if d is None else jnp.float32(d))
    got = tll.lossless_tokens(torch.from_numpy(img), height=h, width=w, distance=d)
    for what, r, g in zip(("tokens", "nbits", "mantissa", "params", "q_sorted"), ref, got):
        g = np.asarray(g) if not torch.is_tensor(g) else np_(g)
        np.testing.assert_array_equal(g.astype(np.int64), np.asarray(r).astype(np.int64), err_msg=what)


@pytest.mark.parametrize("name", ["graphics", "photo_odd"])
def test_colour_and_gradient_transforms_exact(name):
    """YCoCg-R both ways and the unclamped gradient with its prefix-sum
    inverse: equal to the reference's, and exact round trips."""
    img = IMAGES[name]()
    planes = tll.ycocg_forward(torch.from_numpy(img))
    np.testing.assert_array_equal(np_(planes), np.asarray(jll.ycocg_forward(jnp.asarray(img))))
    np.testing.assert_array_equal(np_(tll.ycocg_inverse(planes)), img)
    res = tll.grad_residual(planes)
    np.testing.assert_array_equal(np_(res), np.asarray(jll.grad_residual(jnp.asarray(np_(planes)))))
    back = tll.grad_reconstruct(res)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(np_(back), np_(planes))


@pytest.mark.parametrize("d", sorted(set(RUST_DISTANCES) | set(LEGACY_DISTANCES) | {0.05, 0.15}))
def test_modular_steps_equal(d):
    """Hazard (c): the step law's float32 d**p, computed on the host in the
    port, lands on the reference's integer steps at every sweep distance."""
    np.testing.assert_array_equal(np_(tll.modular_steps(d)), np.asarray(jll.modular_steps(d)))


def _lossless_counts():
    """Per-context histograms of a real modular stream (graphics, d = 0)."""
    img = synth_graphics()
    h, w = img.shape[:2]
    lanes = te.pick_lanes(3 * h * w, 256)
    lay = lossless_layout(h, w, lanes)
    token, _nb, mant, _p, q_sorted = tll.lossless_tokens(torch.from_numpy(img), height=h, width=w)
    tokp, _m, _rows, _f = te.entropy_inputs(token, mant, tll.ll_step_ctx(lay, q_sorted), lay, lanes)
    return np_(te._histogram_stepped(tokp, tll.ll_step_ctx(lay, q_sorted), lanes, lay["n_ctx"]))


def _random_counts():
    """Seeded counts with duplicate rows (exact ties for the merge) and
    empty rows."""
    rng = np.random.default_rng(5)
    c = (rng.pareto(1.5, (12, 52)) * 20).astype(np.int64)
    c[:, 30:] = 0
    c[4] = c[1]
    c[9] = c[1]
    c[7] = c[2]
    c[11] = 0
    return c


@pytest.mark.parametrize("counts", [_lossless_counts, _random_counts], ids=["lossless", "random_dups"])
def test_cluster_histograms_equal(counts):
    """Hazard (b): the greedy merge's float32 entropies and its flat argmin
    over tied pairs give the reference's clusters."""
    c = counts()
    ref_exp, ref_map = jcl.cluster_histograms(jnp.asarray(c, jnp.int32))
    exp, cmap = tcl.cluster_histograms(torch.from_numpy(c))
    print(f"clusters: {len(set(np_(cmap).tolist()))} of {len(c)}")
    np.testing.assert_array_equal(np_(exp), np.asarray(ref_exp))
    np.testing.assert_array_equal(np_(cmap), np.asarray(ref_map))


@pytest.mark.parametrize("d", [0.0, 1.0, 3.0])
def test_reconstruct_lossless_exact(d):
    img = make_test_image(37, 53, seed=3)
    h, w = img.shape[:2]
    tok, nb, mant, params, _q = jll.lossless_tokens(jnp.asarray(img), height=h, width=w, distance=jnp.float32(d))
    tok, nb, mant = (np.asarray(x).astype(np.int64) for x in (tok, nb, mant))
    values = np.where(tok >= 32, (1 << nb) + mant, tok)
    ref = jll.reconstruct_lossless(jnp.asarray(values.astype(np.uint32)), params, height=h, width=w, distance=d)
    got = tll.reconstruct_lossless(torch.from_numpy(values), int(params), height=h, width=w, distance=d)
    np.testing.assert_array_equal(np_(got), np.asarray(ref))
    if d == 0.0:
        np.testing.assert_array_equal(np_(got), img)


# ---- containers


@pytest.mark.parametrize("name", list(IMAGES))
def test_d0_containers_byte_identical(name):
    """d = 0 through encode_image: the same container as the reference's
    (the palette arm wins on glyphs), exact pixels from both decoders."""
    img = IMAGES[name]()
    ref = jenc.encode_image(img, JaxConfig(distance=0.0))
    got = te.encode_image(img, CodecConfig(distance=0.0), device="cpu")
    s = read_container(got)
    print(f"{name}: {len(got)} bytes, palette {len(s.acs_extra) // 3} colours")
    assert got == ref
    assert s.header.lossless and s.header.distance == 0.0
    assert (len(s.acs_extra) > 0) == (name == "glyphs")
    np.testing.assert_array_equal(td.decode_bytes(got, device="cpu"), img)
    np.testing.assert_array_equal(_jax_pixels(got), img)
    if name == "photo_odd":
        assert te.encode_images([(img, CodecConfig(distance=0.0), "")], device="cpu") == [got]


@pytest.mark.parametrize(
    "env,value,shape", [("JXL_TPU_NO_CLUSTER", "1", (41, 57)), ("JXL_TPU_MOD_Q", "2.5,4.0,0.9", (43, 59))]
)
def test_modular_knobs_honoured(monkeypatch, env, value, shape):
    """JXL_TPU_NO_CLUSTER (one table per context) and JXL_TPU_MOD_Q (the
    step law, read by both decoders too) give the reference's bytes and
    pixels. The reference reads both when it traces, so each case uses an
    image shape no other test compiles."""
    monkeypatch.setenv(env, value)
    img = make_test_image(*shape, seed=12)
    got = _port_modular(img, 2.0)
    ref = jenc._modular_async(img, JaxConfig(distance=2.0))()
    assert got == ref
    np.testing.assert_array_equal(td.decode_bytes(got, device="cpu"), _jax_pixels(got))
    monkeypatch.delenv(env)
    assert got != _port_modular(img, 2.0)


def test_palette_rejected_when_plain_wins():
    """A 256-level gradient has <= 256 colours but codes smaller without
    the palette: the port keeps the plain arm, as the reference does."""
    g = np.tile(np.arange(256, dtype=np.uint8), (32, 1))
    img = np.stack([g, g, g], axis=-1)
    got = te.encode_image(img, CodecConfig(distance=0.0), device="cpu")
    assert got == jenc.encode_image(img, JaxConfig(distance=0.0))
    assert len(read_container(got).acs_extra) == 0
    np.testing.assert_array_equal(td.decode_bytes(got, device="cpu"), img)


@pytest.mark.parametrize("name", ["graphics", "photo_odd"])
def test_modular_lossy_containers(name):
    """_modular_async byte-identical to the reference's at every distance,
    within the reference's error bound (tests/test_modular.py), decoded
    exactly alike by both; _modular_grid_async equal to the per-distance
    encodes and to the reference's grid."""
    img = IMAGES[name]()
    ds = [0.5, 1.0, 3.0]
    for d in ds:
        ref = jenc._modular_async(img, JaxConfig(distance=d))()
        got = _port_modular(img, d)
        assert got == ref, d
        out = td.decode_bytes(got, device="cpu")
        np.testing.assert_array_equal(out, _jax_pixels(got))
        sy, sco, scg = np_(tll.modular_steps(d)).tolist()
        bound = (sy + (scg + 1) // 2 + (sco + 1) // 2 + 2) // 2 + 2
        assert np.abs(out.astype(int) - img.astype(int)).max() <= bound
    grid = te._modular_grid_async(torch.from_numpy(img), CodecConfig(), ds, "", _knobs())()
    assert grid == [_port_modular(img, d) for d in ds]
    assert grid == jenc._modular_grid_async(img, JaxConfig(), ds)()


def test_mode_pick():
    """encode_image at d = 1: modular kept on graphics (same bytes as the
    reference), VarDCT kept on the photo; JXL_TPU_MODULAR = 0 / 2
    honoured; the grid picks per point as the reference does."""
    gfx = synth_graphics()
    got = te.encode_image(gfx, CodecConfig(distance=1.0), device="cpu")
    assert read_container(got).header.lossless
    assert got == jenc.encode_image(gfx, JaxConfig(distance=1.0))
    photo = make_test_image(96, 128, seed=9)
    assert not te._modular_candidate(photo, 1)
    assert not read_container(te.encode_image(photo, CodecConfig(distance=1.0), device="cpu")).header.lossless
    vardct = te.encode_image(gfx, CodecConfig(distance=1.0, modular=False), device="cpu")
    assert not read_container(vardct).header.lossless

    ds = [0.5, 2.0, 8.0]
    ref = jenc.encode_image_grid(synth_graphics(seed=3), JaxConfig(), ds)
    grid = te.encode_image_grid(synth_graphics(seed=3), CodecConfig(), ds, device="cpu")
    picks = [(read_container(g).header.lossless, read_container(r).header.lossless) for g, r in zip(grid, ref)]
    print(f"grid picks (port, reference) modular?: {picks}")
    assert all(p == r for p, r in picks)
    for g, r, (mod, _) in zip(grid, ref, picks):
        if mod:
            assert g == r


@pytest.mark.parametrize("mode", ["0", "2"])
def test_mode_env_honoured(monkeypatch, mode):
    monkeypatch.setenv("JXL_TPU_MODULAR", mode)
    img = synth_graphics(seed=4) if mode == "0" else make_test_image(96, 128, seed=9)
    assert te._modular_candidate(img, te.encoder_knobs().modular) == (mode == "2")
    got = te.encode_image(img, CodecConfig(distance=1.0), device="cpu")
    ref = jenc.encode_image(img, JaxConfig(distance=1.0))
    assert read_container(got).header.lossless == read_container(ref).header.lossless
    if mode == "2":
        print(f"forced candidate: modular kept {read_container(got).header.lossless}")


def test_cross_decode_exact():
    """Each decoder on the other's modular containers (modular-lossy at an
    odd size, and palette): the same pixels."""
    img = make_test_image(37, 53, seed=3)
    for data in (jenc._modular_async(img, JaxConfig(distance=1.5))(), _port_modular(img, 1.5)):
        np.testing.assert_array_equal(td.decode_bytes(data, device="cpu"), _jax_pixels(data))
    glyphs = glyph_image(seed=6)
    pal = jenc.encode_image(glyphs, JaxConfig(distance=0.0))
    assert len(read_container(pal).acs_extra) > 0
    np.testing.assert_array_equal(td.decode_bytes(pal, device="cpu"), glyphs)


def test_modular_row_batched_decode():
    """A uniform modular row (lossless and modular-lossy points) through
    decode_bytes_grid_stacked: the batched scan (B2's plain version on the
    CPU, no kernel launch), values equal to the per-stream decodes, pixels
    equal to the per-stream decodes and to jxl_tpu's grid decode. A row with
    a palette stream, or mixing families, returns None."""
    img = synth_graphics(seed=2)
    datas = [jenc.encode_image(img, JaxConfig(distance=0.0))] + jenc._modular_grid_async(
        img, JaxConfig(), [0.7, 1.4, 3.0]
    )()
    streams = [read_container(d) for d in datas]
    assert all(s.header.lossless and not s.acs_extra for s in streams)
    n1, n2 = decode_grouped_cuda.launches, decode_grouped_batched_cuda.launches
    values = td.decode_values_grid(streams, "cpu")
    out = td.decode_bytes_grid_stacked(datas, device="cpu")
    assert (decode_grouped_cuda.launches, decode_grouped_batched_cuda.launches) == (n1, n2)
    assert out.shape == (4,) + img.shape
    for i, (s, d) in enumerate(zip(streams, datas)):
        assert torch.equal(values[i], td.decode_values(s, "cpu"))
        np.testing.assert_array_equal(np_(out[i]), td.decode_bytes(d, device="cpu"))
    np.testing.assert_array_equal(np_(out[0]), img)
    np.testing.assert_array_equal(np_(out), np.asarray(jdec.decode_bytes_grid_stacked(datas)))

    pal = jenc.encode_image(glyph_image(), JaxConfig(distance=0.0))
    assert td.decode_bytes_grid_stacked([pal, pal], device="cpu") is None
    lossy = te.encode_image(img, CodecConfig(distance=1.0, modular=False), device="cpu")
    assert td.decode_bytes_grid_stacked([datas[1], lossy], device="cpu") is None
    s = streams[1]
    other = dataclasses.replace(s, header=dataclasses.replace(s.header, lanes=s.header.lanes * 2))
    assert not td._uniform_row([s, other])
