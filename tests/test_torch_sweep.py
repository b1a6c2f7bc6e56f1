"""The port's sweep harness (jxl_tpu_torch/bench) against jxl_tpu's on the
same tiny test set (the two 32x40 images of tests/test_sweep_stages.py),
on the CPU: both packages sweep d in {0, 1, 3} at e7 under BASELINE and
HOMOGENEITY_PARTITIONING with the legacy stages on.

- results.csv: byte-identical.
- comparisons.csv: columns 0-9 (names, distance, effort, sizes, ratios)
  equal wherever the two containers are byte-identical, and the containers
  of most points are; the metric columns within the battery's bars
  (tests/test_torch_metrics.py) wherever the two decoders return the same
  pixels.
- the legacy tables, the diff images, resume, the A/B files.
"""

import csv
import os

import numpy as np
import pytest

from jxl_tpu.bench import compare as jcmp
from jxl_tpu.bench import csv_schema as jcs
from jxl_tpu.bench import sweep as jsw
from jxl_tpu.codec.config import Strategy as JStrategy
from jxl_tpu.codec.decode import decode_file as jax_decode_file

from jxl_tpu_torch.bench import compare as tcmp
from jxl_tpu_torch.bench import csv_schema as tcs
from jxl_tpu_torch.bench import sweep as tsw
from jxl_tpu_torch.codec.config import Strategy
from jxl_tpu_torch.codec.decode import decode_file
from jxl_tpu_torch.core.io import read_image, write_image

from tests.conftest import make_test_image
from tests.test_torch_metrics import BA_MAX_REL, BA_P3_REL, MSE_REL, PSNR_DB, S2_ABS, SSIM_ABS

DISTANCES = (0.0, 1.0, 3.0)
STRATEGIES = ("BASELINE", "HOMOGENEITY_PARTITIONING")


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    ts = root / "mini"
    ts.mkdir()
    for i in range(2):
        write_image(str(ts / f"im{i}.png"), make_test_image(32, 40, seed=i))
    return str(root)


@pytest.fixture(scope="module")
def runs(tiny_set, tmp_path_factory):
    """{"jax": run dir, "torch": run dir} of the same sweep in each package."""
    out = {}
    for pkg, sw, strat in (("jax", jsw, JStrategy), ("torch", tsw, Strategy)):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        cfg = sw.SweepConfig(
            benchmark_dir=str(tmp_path_factory.mktemp(pkg)),
            test_image_dir=tiny_set,
            distances=DISTANCES,
            efforts=(7,),
            decompress=True,
            compare_images=True,
            **kw,
        )
        runner = sw.SweepRunner(cfg)
        for s in STRATEGIES:
            assert len(runner.run_test_set("mini", strat[s])) == 2 * len(DISTANCES)
        out[pkg] = runner.run_dir
    return out


def _rows(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _res(run: str, strategy: str, name: str) -> str:
    return os.path.join(run, "mini", strategy, "results", name)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_results_csv_identical(runs, strategy):
    with open(_res(runs["jax"], strategy, "results.csv"), "rb") as a, open(_res(runs["torch"], strategy, "results.csv"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_comparisons_csv_matches(runs, strategy):
    ref = _rows(_res(runs["jax"], strategy, "comparisons.csv"))
    got = _rows(_res(runs["torch"], strategy, "comparisons.csv"))
    assert got[0] == ref[0] == jcs.COMPARISON_RESULT_HEADER
    assert len(got) == len(ref) == 1 + 2 * len(DISTANCES)
    same_bytes = same_px = 0
    for r, g in zip(ref[1:], got[1:]):
        assert g[:5] == r[:5] and g[6:8] == r[6:8]  # names, distance, effort, original and raw sizes
        out = os.path.join(strategy, "output", g[1])
        with open(os.path.join(runs["jax"], "mini", out), "rb") as f1, open(os.path.join(runs["torch"], "mini", out), "rb") as f2:
            ref_bytes, got_bytes = f1.read(), f2.read()
        if ref_bytes == got_bytes:
            same_bytes += 1
            assert g[:10] == r[:10]
        else:  # the bars of tests/test_torch_encode.py: bytes within 0.5%
            assert abs(len(got_bytes) - len(ref_bytes)) <= 0.005 * len(ref_bytes)
        px_ref = np.asarray(jax_decode_file(os.path.join(runs["torch"], "mini", out)))
        px_got = decode_file(os.path.join(runs["torch"], "mini", out), device="cpu")
        assert np.abs(px_ref.astype(np.int32) - px_got).max() <= 1
        if ref_bytes == got_bytes and np.array_equal(px_ref, px_got):
            same_px += 1
            gv, rv = [float(x) for x in g[10:17]], [float(x) for x in r[10:17]]
            assert abs(gv[0] - rv[0]) <= MSE_REL * rv[0]
            assert gv[1] == rv[1] or abs(gv[1] - rv[1]) <= PSNR_DB
            assert abs(gv[2] - rv[2]) <= SSIM_ABS and abs(gv[3] - rv[3]) <= SSIM_ABS
            assert abs(gv[4] - rv[4]) <= BA_MAX_REL * rv[4] and abs(gv[5] - rv[5]) <= BA_P3_REL * rv[5]
            assert abs(gv[6] - rv[6]) <= S2_ABS
    assert same_bytes >= len(DISTANCES) and same_px >= len(DISTANCES)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_timings_and_legacy_tables(runs, strategy):
    for pkg in ("jax", "torch"):
        t = _rows(_res(runs[pkg], strategy, "timings.csv"))
        assert t[0] == jsw.TIMINGS_HEADER and len(t) == 1 + 2 * len(DISTANCES)
    assert tsw.TIMINGS_HEADER == jsw.TIMINGS_HEADER and tsw.DECOMPRESSION_HEADER == jsw.DECOMPRESSION_HEADER
    ref = _rows(_res(runs["jax"], strategy, "decompressed.csv"))
    got = _rows(_res(runs["torch"], strategy, "decompressed.csv"))
    assert got[0] == ref[0] == jsw.DECOMPRESSION_HEADER and len(got) == len(ref) == 1 + 2 * len(DISTANCES)
    for r, g in zip(ref[1:], got[1:]):
        assert g[3:8] == r[3:8] and g[9] == r[9] and g[11] == r[11]  # effort, distance, dims, original size / format
        assert int(g[12]) == int(g[10]) - int(g[6]) and int(g[14]) == int(g[10]) - int(g[8])
        np.testing.assert_array_equal(read_image(g[2]), decode_file(g[1], device="cpu"))  # the decompressed PNG
    for pkg in ("jax", "torch"):
        diffs = sorted(os.listdir(os.path.join(runs[pkg], "mini", strategy, "diffs")))
        assert len(diffs) == 2 * len(DISTANCES) and all(d.endswith("-diff.png") for d in diffs)
    d0 = [r for r in _rows(_res(runs["torch"], strategy, "comparisons.csv"))[1:] if float(r[2]) == 0.0]
    assert len(d0) == 2 and all(r[11] == "inf" and float(r[10]) == 0.0 for r in d0)  # d = 0 exact


def test_ab_files_byte_identical(runs, tmp_path):
    """compare_results of the port writes the reference's bytes, on the
    reference's CSVs and on the port's own."""
    for pkg in ("jax", "torch"):
        csvs = [_res(runs[pkg], s, "comparisons.csv") for s in STRATEGIES]
        outs = {}
        for name, mod in (("ref", jcmp), ("port", tcmp)):
            d = str(tmp_path / f"{pkg}-{name}")
            diffs, summary = mod.compare_results(*csvs, d)
            with open(diffs, "rb") as f1, open(summary, "rb") as f2:
                outs[name] = (f1.read(), f2.read())
        assert outs["port"] == outs["ref"]
        assert outs["port"][1].decode().splitlines()[1].startswith("MEAN,MEAN,")


def test_schema_copies_equal():
    for name in ("IMAGE_FILE_DATA_HEADER", "COMPARISON_RESULT_HEADER", "COMPARISON_DIFF_HEADER"):
        assert getattr(tcs, name) == getattr(jcs, name)
    assert (tsw.RUST_DISTANCES, tsw.RUST_EFFORTS, tsw.LEGACY_DISTANCES, tsw.LEGACY_EFFORTS) == (
        jsw.RUST_DISTANCES, jsw.RUST_EFFORTS, jsw.LEGACY_DISTANCES, jsw.LEGACY_EFFORTS,
    )


def test_resume_no_duplicate_rows(tiny_set, tmp_path):
    cfg = tsw.SweepConfig(benchmark_dir=str(tmp_path / "b"), test_image_dir=tiny_set, distances=(1.0,), efforts=(7,), device="cpu")
    runner = tsw.SweepRunner(cfg)
    assert len(runner.run_test_set("mini", Strategy.BASELINE)) == 2
    comp = runner.comparisons_csv("mini", Strategy.BASELINE)
    n1 = len(_rows(comp))
    runner2 = tsw.SweepRunner(cfg, run_dir=runner.run_dir)
    assert runner2.run_test_set("mini", Strategy.BASELINE) == []
    assert len(_rows(comp)) == n1 == 3
    assert tsw.SweepRunner(cfg).run_dir.endswith(os.sep + "1")  # next run number


def test_unported_modes_raise(tmp_path):
    """The mesh mode is a configuration like any other now; what still
    refuses at construction is a malformed mesh spec and a missing device."""
    cfg = tsw.SweepConfig(benchmark_dir=str(tmp_path), mesh="data=2", device="cpu")
    assert tsw.parse_mesh_spec(cfg.mesh, cfg.device).shape == {"data": 2, "space": 1}
    with pytest.raises(ValueError, match="mesh spec"):
        tsw.SweepConfig(benchmark_dir=str(tmp_path), mesh="data=0", device="cpu")
    with pytest.raises(ValueError):
        tsw.SweepConfig(benchmark_dir=str(tmp_path))  # no device
    assert not os.listdir(tmp_path)
