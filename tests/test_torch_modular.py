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
from jxl_tpu_torch.codec.screen import screen_count
from jxl_tpu_torch.cuda_build import launch_counts
from jxl_tpu_torch.entropy import cluster as tcl

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


def _numpy_screen(rgb) -> tuple:
    """The numpy screen the port ran on the host before the count moved to
    torch, written out: (hits, positions, candidate at mode 1)."""
    a = np.asarray(rgb)
    if a.ndim != 3 or a.shape[0] < 2 or a.shape[1] < 2:
        return 0, 0, False
    if a.shape[0] * a.shape[1] > (1 << 24):
        a = a[::4, ::4]
    eqw = (a[:, 1:] == a[:, :-1]).all(axis=2)
    eqn = (a[1:, :] == a[:-1, :]).all(axis=2)
    hits = eqw[1:, :] & eqn[:, 1:]
    return int(hits.sum()), hits.size, float(np.mean(hits)) >= 0.12


def _blocks_11x11(n_blocks: int) -> np.ndarray:
    """11x11 pixels, all distinct, but for `n_blocks` flat 2x2 blocks apart
    from each other: each gives one pixel equal to both its west and north
    neighbours, so n_blocks hits of the 10 x 10 positions."""
    v = np.arange(121).reshape(11, 11)
    img = np.stack([v, np.ones_like(v), np.full_like(v, 7)], axis=-1).astype(np.uint8)
    for i in range(n_blocks):
        r, c = 3 * (i // 4), 3 * (i % 4)
        img[r : r + 2, c : c + 2] = (200, i, 9)
    return img


def _odd_frame() -> np.ndarray:
    img = make_test_image(37, 53, seed=3)
    img[5:30, 10:40] = (200, 100, 50)
    return img


def _big_frame() -> np.ndarray:
    """4097x4096 (just over 2^24 pixels: screened at stride 4), a flat page
    with a patch of 0/1 noise."""
    img = np.full((4097, 4096, 3), 230, np.uint8)
    img[1000:3000, 500:3500] = np.random.default_rng(11).integers(0, 2, (2000, 3000, 3), dtype=np.uint8)
    return img


SCREEN_FRAMES = {
    "photo": lambda: make_test_image(96, 128, seed=9),
    "graphics": lambda: synth_graphics(),
    "flat": lambda: np.full((40, 56, 3), 77, np.uint8),
    "1xW": lambda: make_test_image(1, 64, seed=1),
    "Hx1": lambda: np.full((48, 1, 3), 5, np.uint8),
    "2x2": lambda: np.full((2, 2, 3), 5, np.uint8),
    "odd_37x53": _odd_frame,
    "12_of_100": lambda: _blocks_11x11(12),
    "11_of_100": lambda: _blocks_11x11(11),
    "stride4_4097x4096": _big_frame,
}
SCREEN_WANT = {  # (hits, positions, candidate) where the case pins them
    "1xW": (0, 0, False),
    "Hx1": (0, 0, False),
    "2x2": (1, 1, True),
    "12_of_100": (12, 100, True),
    "11_of_100": (11, 100, False),
}


@pytest.mark.parametrize("case", list(SCREEN_FRAMES))
def test_screen_count_matches_numpy_rule(monkeypatch, case):
    """The plain torch screen (a CPU tensor's path) gives the old numpy
    rule's count, positions and decision, through `screen_count` and
    through `_modular_candidate` on a host array, and the reference's
    decision; no kernel launches."""
    monkeypatch.delenv("JXL_TPU_MODULAR", raising=False)
    img = SCREEN_FRAMES[case]()
    want = _numpy_screen(img)
    assert jenc._modular_candidate(img) == want[2]
    if case in SCREEN_WANT:
        assert want == SCREEN_WANT[case]
    if case.startswith("stride4"):
        assert want[1] == 1024 * 1023
    n0 = launch_counts()["screen"]
    count, n = screen_count(torch.from_numpy(img))
    assert (count, n, n > 0 and count / n >= 0.12) == want
    assert te._modular_candidate(img, 1) == want[2]
    assert te._modular_candidate(torch.from_numpy(img), 1) == want[2]
    assert launch_counts()["screen"] == n0


@pytest.mark.parametrize("case", ["int64", "float64", "gray_2d", "rgba"])
def test_screen_host_array_forms(monkeypatch, case):
    """A host array of another dtype is screened as `_upload` casts it to
    u8, and one that is not [H, W, 3] is no candidate, as in the
    reference."""
    monkeypatch.delenv("JXL_TPU_MODULAR", raising=False)
    g = synth_graphics()
    arr = {
        "int64": g.astype(np.int64),
        "float64": g.astype(np.float64) + 0.25,
        "gray_2d": g[..., 0],
        "rgba": np.concatenate([g, g[..., :1]], axis=-1),
    }[case]
    want = _numpy_screen(np.ascontiguousarray(arr, dtype=np.uint8))[2] if arr.ndim == 3 and arr.shape[2] == 3 else False
    assert te._modular_candidate(arr, 1) == want
    if case.startswith(("int", "float")):
        assert want and jenc._modular_candidate(arr)
    elif case == "gray_2d":
        assert not jenc._modular_candidate(arr)


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
    n1, n2 = launch_counts()["rans_decode"], launch_counts()["rans_decode_batched"]
    values = td.decode_values_grid(streams, "cpu")
    out = td.decode_bytes_grid_stacked(datas, device="cpu")
    assert (launch_counts()["rans_decode"], launch_counts()["rans_decode_batched"]) == (n1, n2)
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
