"""The port's measurement tools (jxl_tpu_torch/tools/) against the
repository's tools/ scripts and the jxl_tpu package, on the CPU at 64x96.

- the numpy helpers the port copies equal the originals: the test-image
  generators' pixels at three seeds, FAMILY and DISTANCES, the bound
  maths (dct_mat exactly, coeff_vars / bound_bpp within 1e-12), the PIL
  anchors, rd_tune.bpp_at;
- each tool that computes codec results holds them against jxl_tpu's own
  calls on the same images (tokens equal on these images at e7, so the
  integer results are exact): rd_point rows, bit_breakdown sections,
  epf_ab deltas and picks, modular_calib, hooka_gated_ab, the corpus RD
  position, and the context studies' ideal bits on jxl_tpu's token
  stream. Bars: container bytes within 0.5%, PSNR within 0.02 dB
  (tests/test_torch_encode.py's);
- profile_stages, profile_codec, batch_scaling and profile_startup run
  once here: every stage row present with a positive time, and the
  full-encode stage's bytes equal encode_image's;
- the file-writing tools write where they are told, the RD report writes
  its table and refuses its figure without matplotlib.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from jxl_tpu.codec import encode as jenc
from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.codec.config import Strategy as JaxStrategy
from jxl_tpu.codec.decode import decode_bytes as jax_decode
from jxl_tpu.codec.decode import decode_bytes_grid_stacked as jax_decode_grid
from jxl_tpu.metrics.quality import calculate_psnr as jax_psnr
from jxl_tpu.metrics.quality import calculate_ssim as jax_ssim

from jxl_tpu_torch import tools as ttools
from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.encode import encode_image
from jxl_tpu_torch.core.io import read_image, write_image
from jxl_tpu_torch.tools import (
    batch_scaling,
    bit_breakdown,
    combo_study,
    ctx_study,
    epf_ab,
    hooka_gated_ab,
    make_test_images,
    modular_calib,
    nnz_study,
    profile_codec,
    profile_stages,
    rd_bound,
    rd_point,
    rd_position_corpus,
    rd_position_report,
    rd_tune,
)

from tests.conftest import make_test_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools import make_test_images as ref_mti  # noqa: E402
from tools import rd_bound as ref_bound  # noqa: E402
from tools import rd_position_corpus as ref_corpus  # noqa: E402
from tools import rd_tune as ref_tune  # noqa: E402

H, W = 64, 96
BYTES_REL = 0.005
PSNR_DB = 0.02


def psnr(a, b) -> float:
    d = np.asarray(a).astype(np.float64) - np.asarray(b).astype(np.float64)
    return float(10 * np.log10(255.0**2 / max(np.mean(d * d), 1e-9)))


@pytest.fixture(scope="module")
def images():
    """A photographic image and a graphics one (a modular candidate)."""
    return {"photo": make_test_image(H, W, seed=5), "graphics": ref_mti.synth_graphics(H, W, 102)}


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


# ---- copied helpers


@pytest.mark.parametrize("gen", sorted({g.__name__ for g in ref_mti.GENERATORS}))
def test_generators_equal_the_reference(gen):
    assert [g.__name__ for g in make_test_images.GENERATORS] == [g.__name__ for g in ref_mti.GENERATORS]
    for seed in (0, 100, 107):
        np.testing.assert_array_equal(getattr(make_test_images, gen)(H, W, seed), getattr(ref_mti, gen)(H, W, seed))


def test_make_test_images_writes_the_reference_pixels(tmp_path):
    make_test_images.main(["--device", "cpu", "--n", "3", "--size", f"{H}x{W}", "--out", str(tmp_path)])
    for i in range(3):
        got = read_image(str(tmp_path / "synth" / f"synth{i:02d}.png"))
        np.testing.assert_array_equal(got, ref_mti.GENERATORS[i](H, W, seed=100 + i))


def test_family_and_distances_equal_the_reference():
    assert rd_position_corpus.FAMILY == ref_corpus.FAMILY
    assert rd_position_corpus.DISTANCES == ref_corpus.DISTANCES
    assert set(rd_position_corpus.FAMILY) == {f[:-4] for f in os.listdir(os.path.join(REPO, "test_images", "synth"))}


@pytest.mark.parametrize("n", [8, 16])
def test_bound_maths_equal_the_reference(n, images):
    np.testing.assert_array_equal(rd_bound.dct_mat(n), ref_bound.dct_mat(n))
    for rgb in images.values():
        v, n2 = rd_bound.coeff_vars(rgb, n)
        rv, rn2 = ref_bound.coeff_vars(rgb, n)
        assert n2 == rn2
        np.testing.assert_allclose(v, rv, rtol=0, atol=1e-12)
        for target in (30.0, 38.0, 45.0):
            assert abs(rd_bound.bound_bpp(v, n2, target) - ref_bound.bound_bpp(rv, rn2, target)) <= 1e-12


def test_anchors_equal_the_reference(images):
    rgb = images["photo"]
    q = (60, 80, 90, 97)
    for fmt in ("JPEG", "WEBP"):
        assert rd_bound.anchor_bpp(rgb, fmt, 38.0, q) == ref_bound.anchor_bpp(rgb, fmt, 38.0, q)
        assert rd_position_corpus.anchor_bpp_curve(rgb, fmt, q) == ref_corpus.anchor_bpp_curve(rgb, fmt, q)


def test_bpp_at_equals_the_reference():
    pts = [[0.7, 3.1, 40.8], [1.0, 2.4, 38.4], [1.45, 1.9, 35.9]]
    for target in (35.0, 35.9, 37.0, 38.4, 40.0, 40.8, 41.0):
        a, b = rd_tune.bpp_at(pts, target), ref_tune.bpp_at(pts, target)
        assert a == b or (np.isnan(a) and np.isnan(b))
        assert rd_position_corpus.interp_bpp([(p[1], p[2]) for p in pts], target) == pytest.approx(a, nan_ok=True)


# ---- codec results against jxl_tpu


def test_rd_point_rows_match_the_reference(images):
    dists = [0.7, 1.0, 1.45]
    got = quiet(rd_point.rd_points, images, dists, 7, "cpu")
    assert list(got) == list(images)
    for name, img in images.items():
        datas = jenc.encode_image_grid(img, JaxConfig(distance=1.0, effort=7), dists)
        dec = jax_decode_grid(datas)
        dec = np.asarray(dec) if dec is not None else np.stack([np.asarray(jax_decode(d)) for d in datas])
        for (d, bpp, p), data, rec in zip(got[name], datas, dec):
            assert abs(bpp / (len(data) * 8 / (H * W)) - 1) <= BYTES_REL, (name, d)
            assert abs(p - psnr(img, rec)) <= PSNR_DB, (name, d)
    assert json.loads(json.dumps(got)) == got


def test_bit_breakdown_sections_match_the_reference(images, monkeypatch):
    monkeypatch.setenv("JXL_TPU_BREAKDOWN_CPU", "0")  # the reference's import-time platform switch
    from tools import bit_breakdown as ref_bb

    rgb = images["photo"]
    res = bit_breakdown.breakdown(rgb, 1.0, 7, "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref_data = ref_bb.breakdown(rgb, 1.0, 7)
    lines = out.getvalue().splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("section"))
    ref_rows = {}
    for line in lines[start + 1 :]:
        f = line.split()
        if f[0] == "SUM":
            break
        ref_rows[f[0]] = (float(f[1]), float(f[2]), int(f[4]), int(f[5]))
    assert [r[0] for r in res["rows"]] == list(ref_rows)
    for name, tb, mb, ntok, nz in res["rows"]:
        rtb, rmb, rntok, rnz = ref_rows[name]
        assert (ntok, nz, round(mb)) == (rntok, rnz, rmb), name
        assert abs(tb - rtb) <= max(1.0, BYTES_REL * rtb), name
    assert abs(len(res["data"]) / len(ref_data) - 1) <= BYTES_REL
    sec, pay = bit_breakdown.payload_bits(res)
    assert abs(sec / pay - 1) <= 1e-3, (sec, pay)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        bit_breakdown.print_breakdown(res, H, W, 1.0, 7)
    assert "SUM" in text.getvalue() and "payload" in text.getvalue()


def test_epf_ab_matches_the_reference(images):
    img = images["photo"]
    dists = [1.0, 4.0]
    rows = quiet(epf_ab.epf_rows, {"photo": img}, dists, "cpu")
    assert epf_ab.FLAGS_OFFSET == 19
    for (name, d, bpp, p_on, p_off, s_on, s_off, pick), dist in zip(rows, dists):
        data = jenc.encode_image(img, JaxConfig(distance=dist, effort=7, epf=True, modular=False))
        on = np.asarray(jax_decode(epf_ab.set_epf_flag(data, True)))
        off = np.asarray(jax_decode(epf_ab.set_epf_flag(data, False)))
        assert (name, d) == ("photo", dist)
        assert pick == ("on" if data[epf_ab.FLAGS_OFFSET] & 1 else "off")
        assert abs(bpp / (len(data) * 8 / (H * W)) - 1) <= BYTES_REL
        assert abs(p_on - float(jax_psnr(img, on))) <= PSNR_DB and abs(p_off - float(jax_psnr(img, off))) <= PSNR_DB
        assert abs((p_on - p_off) - (float(jax_psnr(img, on)) - float(jax_psnr(img, off)))) <= PSNR_DB
        assert abs(s_on - float(jax_ssim(img, on))) <= 1e-4 and abs(s_off - float(jax_ssim(img, off))) <= 1e-4
    assert "| photo | 1.0 |" in epf_ab.report(rows, "cpu")


@pytest.mark.parametrize("name", ["photo", "graphics"])
def test_modular_calib_matches_the_reference(name, images):
    rgb = images[name]
    dists = (1.0, 3.0)
    rows = quiet(modular_calib.calib_rows, {name: rgb}, dists, "cpu")
    var = jenc.encode_image_grid_async(rgb, JaxConfig(distance=1.0, effort=7, modular=False), list(dists))()
    mod = jenc._modular_grid_async(rgb, JaxConfig(distance=1.0, effort=7), list(dists))()
    byte_win, sse_tol, sse_win, byte_tol = jenc._mode_rule()
    for r, d, v, m in zip(rows, dists, var, mod):
        assert r["d"] == d and r["n_px"] == H * W
        assert r["mod_bytes"] == len(m)  # the modular family is integer end to end
        assert abs(r["var_bytes"] / len(v) - 1) <= BYTES_REL
        rec_v, rec_m = np.asarray(jax_decode(v)), np.asarray(jax_decode(m))
        assert abs(r["var_psnr"] - psnr(rgb, rec_v)) <= PSNR_DB
        assert r["mod_psnr"] == psnr(rgb, rec_m)
        assert r["candidate"] == bool(jenc._modular_candidate(rgb))
        rv, rm = len(v), len(m)
        sv = float(np.sum((rec_v.astype(np.float64) - rgb) ** 2))
        sm = float(np.sum((rec_m.astype(np.float64) - rgb) ** 2))
        assert r["pick_modular"] == bool(
            (rm <= rv and sm <= sv) or (rm <= byte_win * rv and sm <= sse_tol * sv) or (sm <= sse_win * sv and rm <= byte_tol * rv)
        )
    if name == "graphics":
        assert rows[0]["candidate"]


def test_hooka_gated_ab_matches_the_reference(images):
    rgb = images["graphics"]
    rows = quiet(hooka_gated_ab.ab_rows, {"graphics": rgb}, hooka_gated_ab.DISTANCES, "cpu")
    for arm in hooka_gated_ab.ARMS:
        cfg = JaxConfig(distance=1.0, effort=7, strategy=JaxStrategy[arm], modular=False)
        datas = jenc.encode_image_grid(rgb, cfg, list(hooka_gated_ab.DISTANCES))
        for r, data in zip(rows, datas):
            assert abs(r[f"{arm}_bytes"] / len(data) - 1) <= BYTES_REL, (arm, r["d"])
            assert abs(r[f"{arm}_psnr"] - psnr(rgb, np.asarray(jax_decode(data)))) <= PSNR_DB, (arm, r["d"])
    assert hooka_gated_ab.report(rows, "cpu").count("| graphics |") == 2


def test_rd_position_rows_match_the_reference(images):
    rgb = images["photo"]
    (row,) = quiet(rd_position_corpus.position_rows, {"synth00": rgb}, "cpu")
    datas = jenc.encode_image_grid(rgb, JaxConfig(distance=1.0, effort=7), list(ref_corpus.DISTANCES))
    i = ref_corpus.DISTANCES.index(1.0)
    target = psnr(rgb, np.asarray(jax_decode(datas[i])))
    assert row["family"] == "photo"
    assert abs(row["target"] - target) <= PSNR_DB
    assert abs(row["codec"] / (len(datas[i]) * 8 / (H * W)) - 1) <= BYTES_REL
    v8, n8 = ref_bound.coeff_vars(rgb, 8)
    assert row["bound"] == pytest.approx(ref_bound.bound_bpp(v8, n8, row["target"]), abs=1e-12)
    jpeg = ref_corpus.interp_bpp(ref_corpus.anchor_bpp_curve(rgb, "JPEG", (60, 70, 80, 85, 90, 92, 95, 97)), row["target"])
    assert row["jpeg"] == pytest.approx(jpeg, nan_ok=True)
    assert "| ALL |" in rd_position_corpus.report([row], "cpu")


@pytest.mark.parametrize("study", ["nnz_study", "ctx_study", "combo_study"])
def test_studies_equal_on_the_reference_tokens(study, images, monkeypatch):
    """Each study's ideal bits from the port's token stream equal those
    from jxl_tpu's stream of the same image (the study code is the same;
    this holds the streams, and so the studies, to the reference)."""
    import torch

    from jxl_tpu.codec.analysis import encode_tokens_for_analysis as jax_entry

    import jxl_tpu_torch.codec.analysis as tan

    mod = {"nnz_study": nnz_study, "ctx_study": ctx_study, "combo_study": combo_study}[study]

    def run(rgb, d):
        if study == "nnz_study":
            return nnz_study.study_image("x", rgb, d, "cpu")
        return quiet(mod.study, "x", rgb, d, "cpu")

    for rgb in images.values():
        for d in (1.0, 3.0):
            got = run(rgb, d)
            with monkeypatch.context() as m:
                m.setattr(
                    tan, "encode_tokens_for_analysis",
                    lambda rgb, dist, *, height, width, effort=7, device: [
                        torch.from_numpy(np.asarray(a).astype(np.int32)) if i < 3 else a
                        for i, a in enumerate(jax_entry(rgb, dist, height=height, width=width, effort=effort))
                    ],
                )
                ref = run(rgb, d)
            assert got == ref
    if study == "nnz_study":
        s = nnz_study.summary(got)
        assert s["ac_bits_now"] > 0 and len(s["net_saving_pct_of_ac"]) == 3


# ---- profilers, once on the CPU


def test_profile_stages_rows(images):
    img = images["photo"]
    res = profile_stages.profile(img, "cpu", reps=1)
    assert list(res["stages"]) == list(profile_stages.STAGES)
    assert all(t["ms"] > 0 and t["busy_ms"] is None for t in res["stages"].values())
    assert res["bytes"] == encode_image(img, CodecConfig(distance=1.0, effort=7), device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        profile_stages.print_table(res, "cpu", H, W)
    assert out.getvalue().startswith("device=cpu") and all(s in out.getvalue() for s in profile_stages.STAGES)


def test_profile_codec_rows(images):
    img = images["photo"]
    res = profile_codec.profile(img, "cpu", reps=1)
    assert list(res["stages"]) == list(profile_codec.STAGES)
    assert all(t["ms"] > 0 for t in res["stages"].values())
    assert res["bytes"] == encode_image(img, CodecConfig(distance=1.0, effort=7), device="cpu")


def test_batch_scaling_rows(images, tmp_path):
    rows = quiet(batch_scaling.scaling_rows, images["photo"], "cpu", batches=(1, 2), iters=2)
    assert [r[0] for r in rows] == [1, 2]
    assert all(v > 0 for r in rows for v in r[1:])
    text = batch_scaling.report(rows, "cpu", H, W)
    assert "| 2 |" in text and text.startswith("# Batch-scaling curve: cpu")


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_profile_startup_marks(mode, images, tmp_path):
    src = str(tmp_path / "in.png")
    write_image(src, images["photo"])
    if mode == "decode":
        with open(tmp_path / "in.jxt", "wb") as f:
            f.write(encode_image(images["photo"], CodecConfig(), device="cpu"))
        argv = [str(tmp_path / "in.jxt"), "--out", str(tmp_path / "out.png")]
        io_marks = ["read+parse_container", "decode_1_first", "decode_2_steady", "write_output"]
    else:
        argv = ["--encode", src, "--out", str(tmp_path / "out.jxt")]
        io_marks = ["read_input", "encode_1_first", "encode_2_steady", "write_output"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-m", "jxl_tpu_torch.tools.profile_startup", "--device", "cpu", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 0, p.stderr
    res = json.loads(p.stdout.strip().splitlines()[-1])
    marks = ["import_torch", "import_jxl_tpu_torch", "device_context[cpu]", "first_tiny_launch", "kernel_build_or_load"]
    assert list(res["phase_s"]) == marks + io_marks
    assert all(v > 0 for v in res["phase_s"].values()) and res["device"] == "cpu"
    assert res["total_s"] >= sum(res["phase_s"].values()) - 1e-9
    out = tmp_path / ("out.png" if mode == "decode" else "out.jxt")
    assert out.exists()
    if mode == "encode":
        assert out.read_bytes() == encode_image(images["photo"], CodecConfig(), device="cpu")


# ---- the CLI surfaces


def test_rd_tune_runs_rd_point_per_variant(monkeypatch):
    seen = []

    def fake_run(cmd, env, cwd, **kw):
        seen.append((cmd, {k: env.get(k) for k in ("JXL_TPU_RDO_KAPPA", "JXL_TPU_DEADZONE")}, cwd))
        out = json.dumps({"bench": [[0.7, 2.0, 39.0], [1.0, 1.5, 37.5]]})
        return subprocess.CompletedProcess(cmd, 0, stdout=out + "\n", stderr="")

    monkeypatch.setattr(rd_tune.subprocess, "run", fake_run)
    res = quiet(rd_tune.main, ["--device", "cpu", "base", "JXL_TPU_RDO_KAPPA=0.2 JXL_TPU_DEADZONE=0.3"])
    assert list(res) == ["base", "JXL_TPU_RDO_KAPPA=0.2 JXL_TPU_DEADZONE=0.3"]
    assert seen[0][0][1:] == ["-m", "jxl_tpu_torch.tools.rd_point", "--device", "cpu"]
    assert seen[1][1] == {"JXL_TPU_RDO_KAPPA": "0.2", "JXL_TPU_DEADZONE": "0.3"} and seen[1][2] == REPO


def test_rd_bound_prints_bounds_anchors_and_the_codec(images, tmp_path):
    src = str(tmp_path / "in.png")
    write_image(src, images["photo"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rd_bound.main([src, "--psnr", "38.0", "--device", "cpu"])
    text = out.getvalue()
    v, n2 = ref_bound.coeff_vars(images["photo"], 8)
    assert f"(8x8 DCT): {ref_bound.bound_bpp(v, n2, 38.0):.4f} bpp" in text
    assert "JPEG (PIL)" in text and "WebP" in text and "this codec (e7, cpu)" in text


@pytest.mark.parametrize("have_matplotlib", [True, False])
def test_rd_position_report_table_and_figure(have_matplotlib, tmp_path, monkeypatch):
    cur = {"bench": [[0.7, 2.0, 40.0], [1.0, 1.5, 38.4], [1.45, 1.1, 36.0]]}
    prev = {"bench": [[0.7, 2.2, 40.0], [1.0, 1.7, 38.4], [1.45, 1.2, 36.0]]}
    for name, obj in (("cur.json", cur), ("prev.json", prev)):
        (tmp_path / name).write_text(json.dumps(obj))
    argv = [str(tmp_path / "cur.json"), str(tmp_path / "prev.json"), "--device", "cpu", "--out", str(tmp_path / "r.md")]
    if have_matplotlib:
        pytest.importorskip("matplotlib")
        quiet(rd_position_report.main, argv)
        assert (tmp_path / "rd_curve.png").stat().st_size > 0
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(RuntimeError, match="the RD figure needs matplotlib"):
            quiet(rd_position_report.main, argv)
        assert not (tmp_path / "rd_curve.png").exists()
    text = (tmp_path / "r.md").read_text()
    assert "| **this codec (current, e7)** | **" in text and "| 1.0 | 1.5000 | 38.40 | 1.7000 | 38.40 |" in text


def test_writers_take_their_output_path(tmp_path):
    """A writing tool's table goes where --out says (defaults: the hygiene
    test holds them under benchmarks/)."""
    ttools.write_text(str(tmp_path / "a" / "t.md"), "x\n")
    assert (tmp_path / "a" / "t.md").read_text() == "x\n"
    assert ttools.default_out("epf_ab", "epf_ab.md") == epf_ab.OUT
