"""Port parity: the grid path of jxl_tpu_torch against jxl_tpu, on the CPU.

- (a) the batched decode scan's plain version (`decode_grouped_batched`,
  kernel B2's oracle) is bit-exact against the port's single-stream scan
  run stream by stream and against the reference's XLA scan (what
  `_decode_packed_grid` runs off-TPU): values, states and pointers, both
  phases joined by the carry, streams with unequal counts sharing caps;
- (b) a grid row the reference wrote (a half flat / half busy image whose
  points carry different EPF decisions) decodes with value streams
  bit-exact against the reference's, pixels within 1 LSB of the reference's
  grid decode and identical to the port's per-stream decodes;
- (c) the reference's None contract, and uniform lossless rows batching;
- (d) the port's grid and batch encodes are byte-identical to its
  `encode_image`, with the reference's distance rules;
- (e) port grid containers against the reference's: bytes within 0.5%,
  PSNR within 0.02 dB per point, decodable both ways within 1 LSB.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.codec.decode import decode_bytes as jax_decode
from jxl_tpu.codec.decode import decode_bytes_grid_stacked as jax_grid_decode
from jxl_tpu.codec.encode import encode_image as jax_encode
from jxl_tpu.codec.encode import encode_image_grid as jax_encode_grid
from jxl_tpu.entropy import grouped as jg
from jxl_tpu.entropy.pallas_rans import MANT_SLACK, WORD_SLACK

from jxl_tpu_torch.codec import decode as td
from jxl_tpu_torch.codec import encode as te
from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.container import read_container
from jxl_tpu_torch.cuda_build import launch_counts
from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_batched_cuda
from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_plain
from jxl_tpu_torch.entropy.grouped import decode_grouped, decode_grouped_batched

from tests.conftest import make_test_image
from tests.test_pallas_enc import _stream
from tests.test_torch_decode import jax_values
from tests.test_torch_encode import psnr, sections
from tests.test_v8_features import _mixed_image
from tests.torch_parity import front_pack, np_, stream_from_jax, t64, values_from_tokens

LANES = 256
G = LANES // 128
GRID_D = [0.6, 1.0, 4.0, 9.0]


# ---- (a) the batched scan's plain version


@pytest.fixture(scope="module")
def batch3():
    """Three streams at 256 lanes, unequal lengths of word and byte streams
    (different seeds and mantissa mixes), encoded by the port, front-packed
    at shared caps; plus their expected values."""
    T = 60
    enc, rows, vals = [], [], []
    for seed in (11, 12, 13):
        token, nbits, mant, step_ctx, freq, cum = _stream(T * LANES, LANES, seed=seed)
        tokp, mantp, r = stream_from_jax(token, mant, step_ctx, freq, cum)
        capw, capm = enc_caps(T, LANES)
        enc.append(encode_grouped_plain(tokp, mantp, r, T=T, lanes=LANES, capw=capw, capm=capm))
        rows.append(r)
        vals.append(values_from_tokens(token, nbits, mant))
    capw = max(int(e[3].max()) for e in enc)
    capm = max(int(e[4].max()) for e in enc)
    words = [front_pack(np_(e[0]), np_(e[3]), capw) for e in enc]
    mants = [front_pack(np_(e[1]), np_(e[4]), capm) for e in enc]
    counts = [(np_(e[3]), np_(e[4])) for e in enc]
    assert len({int(c[0].sum()) for c in counts}) == 3 and len({int(c[1].sum()) for c in counts}) == 3
    return dict(
        T=T, t_a=T // 3, words=words, mants=mants, states=[np_(e[2]) for e in enc],
        rows=rows, vals=vals, counts=counts,
    )


def _two_phase(fn, words, mants, states, rows, ptr0, T, t_a):
    va, st, p = fn(words, mants, states, rows[:t_a].contiguous(), ptr0, T=t_a, lanes=LANES)
    vb, st2, p2 = fn(words, mants, st, rows[t_a:].contiguous(), p, T=T - t_a, lanes=LANES)
    return va, st, p, vb, st2, p2


def test_batched_scan_matches_per_stream(batch3):
    b = batch3
    T, t_a, B = b["T"], b["t_a"], 3
    words = torch.from_numpy(np.concatenate(b["words"]))
    mants = torch.from_numpy(np.concatenate(b["mants"]))
    states = t64(np.stack(b["states"]))
    rows = torch.stack(b["rows"], dim=1)
    ptr0 = torch.zeros((2, B * G), dtype=torch.int32)
    n0 = launch_counts()["rans_decode_batched"]
    got = _two_phase(decode_grouped_batched_cuda, words, mants, states, rows, ptr0, T, t_a)
    assert launch_counts()["rans_decode_batched"] == n0  # CPU tensors: plain version
    plain = _two_phase(decode_grouped_batched, words, mants, states, rows, ptr0, T, t_a)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    va, st, p, vb, st2, p2 = got
    assert va.shape == (B, t_a * LANES) and st2.shape == (B, LANES) and p2.shape == (2, B * G)
    for i in range(B):
        one = _two_phase(
            decode_grouped, torch.from_numpy(b["words"][i]), torch.from_numpy(b["mants"][i]),
            t64(b["states"][i]), b["rows"][i], torch.zeros((2, G), dtype=torch.int32), T, t_a,
        )
        gs = slice(i * G, (i + 1) * G)
        assert torch.equal(va[i], one[0]) and torch.equal(vb[i], one[3])
        assert torch.equal(st[i], one[1]) and torch.equal(st2[i], one[4])
        assert torch.equal(p[:, gs], one[2]) and torch.equal(p2[:, gs], one[5])
        np.testing.assert_array_equal(np_(torch.cat([va[i], vb[i]])).astype(np.int64), b["vals"][i])
        # both phases together consume each group's streams exactly
        np.testing.assert_array_equal(np_(p2[:, gs]), np.stack(b["counts"][i]))


def test_batched_scan_matches_xla(batch3):
    """Each stream of the batch against the reference's XLA scan (with its
    read-ahead slack), phase by phase with the carry."""
    b = batch3
    T, t_a, B = b["T"], b["t_a"], 3
    words = torch.from_numpy(np.concatenate(b["words"]))
    mants = torch.from_numpy(np.concatenate(b["mants"]))
    va, st, p, vb, st2, p2 = _two_phase(
        decode_grouped_batched, words, mants, t64(np.stack(b["states"])), torch.stack(b["rows"], dim=1),
        torch.zeros((2, B * G), dtype=torch.int32), T, t_a,
    )
    for i in range(B):
        wg = np.pad(b["words"][i], ((0, 0), (0, WORD_SLACK))).astype(np.uint32)
        mg = np.pad(b["mants"][i], ((0, 0), (0, MANT_SLACK))).astype(np.uint32)
        rows = jnp.asarray(np_(b["rows"][i]))
        ja, jst, jgp, jbp = jg.decode_grouped(
            jnp.asarray(wg), jnp.asarray(mg), jnp.asarray(b["states"][i].astype(np.uint32)),
            rows[:t_a], T=t_a, lanes=LANES, return_carry=True,
        )
        jb, jst2, jgp2, jbp2 = jg.decode_grouped(
            jnp.asarray(wg), jnp.asarray(mg), jst, rows[t_a:], T=T - t_a, lanes=LANES,
            gptr0=jgp, bptr0=jbp, return_carry=True,
        )
        gs = slice(i * G, (i + 1) * G)
        np.testing.assert_array_equal(np_(va[i]).astype(np.int64), np.asarray(ja).astype(np.int64))
        np.testing.assert_array_equal(np_(vb[i]).astype(np.int64), np.asarray(jb).astype(np.int64))
        np.testing.assert_array_equal(np_(st[i]), np.asarray(jst).astype(np.int64))
        np.testing.assert_array_equal(np_(st2[i]), np.asarray(jst2).astype(np.int64))
        np.testing.assert_array_equal(np_(p[:, gs]), np.stack([np.asarray(jgp), np.asarray(jbp)]))
        np.testing.assert_array_equal(np_(p2[:, gs]), np.stack([np.asarray(jgp2), np.asarray(jbp2)]))


# ---- (b), (e): one grid row written by each side


@pytest.fixture(scope="module")
def row():
    img = _mixed_image(96, 128, seed=9)
    jax_datas = jax_encode_grid(img, JaxConfig(effort=5, modular=False), GRID_D)
    port_datas = te.encode_image_grid(img, CodecConfig(effort=5, modular=False), GRID_D, device="cpu")
    return img, jax_datas, port_datas


def test_grid_decode_of_reference_row(row):
    _img, jax_datas, _port = row
    streams = [read_container(d) for d in jax_datas]
    epf = [s.header.epf for s in streams]
    print(f"EPF flags across the row: {epf}")
    assert len(set(epf)) == 2, "the row should mix EPF decisions"
    n0 = launch_counts()["rans_decode_batched"]
    values = td.decode_values_grid(streams, "cpu")
    assert launch_counts()["rans_decode_batched"] == n0
    for i, d in enumerate(jax_datas):
        np.testing.assert_array_equal(np_(values[i]).astype(np.int64), jax_values(d).astype(np.int64))
    got = td.decode_bytes_grid_stacked(jax_datas, device="cpu")
    assert got.shape == (len(GRID_D), 96, 128, 3) and got.dtype == torch.uint8
    ref = np.asarray(jax_grid_decode(jax_datas)).astype(np.int32)
    diff = np.abs(np_(got).astype(np.int32) - ref)
    print(f"grid pixels vs reference grid decode: max |d| {diff.max()} LSB, {np.mean(diff > 0):.4%} differ")
    assert diff.max() <= 1
    for i, d in enumerate(jax_datas):
        np.testing.assert_array_equal(np_(got[i]), td.decode_bytes(d, device="cpu"))
    listed = td.decode_bytes_grid_device(jax_datas, device="cpu")
    assert len(listed) == len(GRID_D) and all(torch.equal(a, b) for a, b in zip(listed, got))


def test_grid_containers_match_reference(row):
    img, jax_datas, port_datas = row
    for d, jd_, pd_ in zip(GRID_D, jax_datas, port_datas):
        q_jax = psnr(img, np.asarray(jax_decode(jd_)))
        q_port = psnr(img, np.asarray(jax_decode(pd_)))
        rel = len(pd_) / len(jd_) - 1.0
        acs_flips = int((sections(jd_)[1] != sections(pd_)[1]).sum())
        print(
            f"d={d}: bytes {len(pd_)} vs {len(jd_)} ({rel:+.4%}), PSNR {q_port:.4f} vs {q_jax:.4f} dB, "
            f"ACS decisions differing: {acs_flips}"
        )
        assert abs(rel) <= 0.005
        assert abs(q_port - q_jax) <= 0.02
        for data in (jd_, pd_):
            a = np.asarray(jax_decode(data)).astype(np.int32)
            b = td.decode_bytes(data, device="cpu").astype(np.int32)
            assert np.abs(a - b).max() <= 1
    stacked = td.decode_bytes_grid_stacked(port_datas, device="cpu")
    ref = np.asarray(jax_grid_decode(port_datas)).astype(np.int32)
    assert np.abs(np_(stacked).astype(np.int32) - ref).max() <= 1


# ---- (c) the None contract


def test_grid_decode_none_contract():
    a = te.encode_image(make_test_image(32, 48, seed=1), CodecConfig(distance=1.0), device="cpu")
    b = te.encode_image(make_test_image(40, 48, seed=1), CodecConfig(distance=1.0), device="cpu")
    assert td.decode_bytes_grid_stacked([a], device="cpu") is None
    assert td.decode_bytes_grid_stacked([a, b], device="cpu") is None
    listed = td.decode_bytes_grid_device([a, b], device="cpu")
    np.testing.assert_array_equal(np_(listed[1]), td.decode_bytes(b, device="cpu"))
    # same geometry, another lane count (small images all pick 128 lanes,
    # so the second header is edited)
    s = read_container(a)
    wide = dataclasses.replace(s, header=dataclasses.replace(s.header, lanes=256))
    assert td._uniform_row([s, s]) and not td._uniform_row([s, wide])


def test_grid_decode_lossless_row_raises():
    """A uniform row of the reference's d = 0 containers (no palette) no
    longer raises: it decodes through the batched scan to exact pixels."""
    from jxl_tpu.codec.encode import _modular_async

    imgs = [make_test_image(16, 24, seed=2), make_test_image(16, 24, seed=2)[::-1].copy()]
    datas = [_modular_async(im, JaxConfig(distance=0.0))() for im in imgs]
    out = td.decode_bytes_grid_stacked(datas, device="cpu")
    assert out.shape == (2, 16, 24, 3)
    for im, o in zip(imgs, out):
        np.testing.assert_array_equal(np_(o), im)


# ---- (d) grid and batch encodes against encode_image


def test_grid_and_batch_encodes_match_encode_image():
    img = make_test_image(48, 64, seed=3)
    cfg = CodecConfig(effort=7)
    ds = [0.0, 0.5, 1.0, 4.0]
    grid = te.encode_image_grid(img, cfg, ds, orig_name="g.png", device="cpu")
    assert len(grid) == len(ds)
    for d, data in zip(ds, grid):
        # d = 0 is floored to 0.05 in a grid: lossy, like the reference
        single = te.encode_image(img, CodecConfig(distance=max(d, 0.05), effort=7), "g.png", device="cpu")
        assert data == single, d
    assert read_container(grid[0]).header.distance == pytest.approx(0.05)

    other = make_test_image(48, 64, seed=4)
    fin = te.encode_images_batched_async([img, other], cfg, [1.0, 2.0], ["a", "b"], device="cpu")
    out = fin()
    assert out[0] == te.encode_image(img, CodecConfig(distance=1.0), "a", device="cpu")
    assert out[1] == te.encode_image(other, CodecConfig(distance=2.0), "b", device="cpu")
    assert te.encode_images([(img, CodecConfig(distance=4.0), "g.png")], device="cpu") == [grid[3]]
    with pytest.raises(ValueError):
        te.encode_images_batched_async([img], cfg, [0.0], device="cpu")


def test_grid_encode_refuses_unported_modes():
    """What the grid once refused now encodes: a modular candidate picks its
    family per point as the reference does, modular=False keeps VarDCT,
    and e8 runs."""
    flat = np.zeros((32, 48, 3), np.uint8)
    flat[8:24, 8:40] = (200, 40, 90)
    picked = te.encode_image_grid(flat, CodecConfig(), [1.0, 2.0], device="cpu")
    ref = jax_encode_grid(flat, JaxConfig(), [1.0, 2.0])
    modes = [read_container(b).header.lossless for b in picked]
    assert modes == [read_container(b).header.lossless for b in ref] and modes[0]
    for d, b in zip([1.0, 2.0], picked):
        assert b == te.encode_image(flat, CodecConfig(distance=d), device="cpu")
    vardct = te.encode_image_grid(flat, CodecConfig(modular=False), [1.0, 2.0], device="cpu")
    assert not any(read_container(b).header.lossless for b in vardct)
    e8 = te.encode_image_grid(make_test_image(32, 48), CodecConfig(effort=8), [1.0], device="cpu")
    assert read_container(e8[0]).header.effort == 8
