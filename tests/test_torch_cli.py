"""The port's CLI (`python -m jxl_tpu_torch`, jxl_tpu_torch/cli/main.py) on
the CPU: encode / decode / bench / compare, the required --device,
`encode --stripes` and `bench --mesh`, and what cannot run refusing before
any work."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jxl_tpu.bench import csv_schema as jcs
from jxl_tpu.bench import sweep as jsw
from jxl_tpu.bench.compare import compare_results as ref_compare
from jxl_tpu.codec.decode import decode_file as jax_decode_file

from jxl_tpu_torch.cli.main import main
from jxl_tpu_torch.codec.decode import decode_file
from jxl_tpu_torch.core.io import read_image, write_image

from tests.conftest import make_test_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_imgs")
    (root / "mini").mkdir()
    for i in range(2):
        write_image(str(root / "mini" / f"im{i}.png"), make_test_image(32, 40, seed=10 + i))
    return str(root)


def _csv_header(path: str) -> list:
    with open(path) as f:
        return f.readline().rstrip("\r\n").split(",")


def test_encode_decode_round_trip(tiny_set, tmp_path, capsys):
    src = os.path.join(tiny_set, "mini", "im0.png")
    jxt, back = str(tmp_path / "a.jxt"), str(tmp_path / "a.png")
    assert main(["encode", src, jxt, "--device", "cpu", "--distance", "1.5", "--effort", "6"]) == 0
    assert "bytes" in capsys.readouterr().out
    assert main(["decode", jxt, back, "--device", "cpu"]) == 0
    px = decode_file(jxt, device="cpu")
    np.testing.assert_array_equal(read_image(back), px)
    # the port's container decodes in jxl_tpu, within the pixel bar
    assert np.abs(np.asarray(jax_decode_file(jxt)).astype(np.int32) - px).max() <= 1
    orig = read_image(src)
    assert 10.0 * np.log10(255.0**2 / np.mean((orig.astype(np.float64) - px) ** 2)) > 30.0


def test_bench_writes_the_reference_files(tiny_set, tmp_path):
    bench = str(tmp_path / "bench")
    argv = [
        "bench", "--device", "cpu", "--test-image-dir", tiny_set, "--benchmark-dir", bench,
        "--distances", "1", "3", "--efforts", "7", "--compare-to", "HOMOGENEITY_PARTITIONING",
    ]
    assert main(argv) == 0
    base = os.path.join(bench, "0", "mini")
    for strat in ("BASELINE", "HOMOGENEITY_PARTITIONING"):
        res = os.path.join(base, strat, "results")
        assert _csv_header(os.path.join(res, "results.csv")) == jcs.IMAGE_FILE_DATA_HEADER
        assert _csv_header(os.path.join(res, "comparisons.csv")) == jcs.COMPARISON_RESULT_HEADER
        assert _csv_header(os.path.join(res, "timings.csv")) == jsw.TIMINGS_HEADER
        assert len(os.listdir(os.path.join(base, strat, "output"))) == 4
    assert _csv_header(os.path.join(base, "comparison_diffs.csv")) == jcs.COMPARISON_DIFF_HEADER
    assert _csv_header(os.path.join(base, "summary.csv")) == jcs.COMPARISON_DIFF_HEADER
    with open(os.path.join(base, "summary.csv")) as f:
        assert f.read().splitlines()[1].startswith("MEAN,MEAN,")

    # compare: the same two CSVs through the CLI give the reference's bytes
    csvs = [os.path.join(base, s, "results", "comparisons.csv") for s in ("BASELINE", "HOMOGENEITY_PARTITIONING")]
    assert main(["compare", *csvs, str(tmp_path / "cmp")]) == 0
    ref = ref_compare(*csvs, str(tmp_path / "cmp_ref"))
    for name, ref_path in zip(("comparison_diffs.csv", "summary.csv"), ref):
        with open(tmp_path / "cmp" / name, "rb") as a, open(ref_path, "rb") as b:
            assert a.read() == b.read()


def test_bench_profile_writes_a_trace(tiny_set, tmp_path):
    prof = str(tmp_path / "prof")
    argv = [
        "bench", "--device", "cpu", "--test-image-dir", tiny_set, "--benchmark-dir", str(tmp_path / "b"),
        "--distances", "2", "--efforts", "7", "--profile", prof,
    ]
    assert main(argv) == 0
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0


@pytest.mark.parametrize(
    "argv",
    [["encode", "a.png", "b.jxt"], ["decode", "b.jxt", "c.png"], ["bench", "--distances", "1"]],
    ids=["encode", "decode", "bench"],
)
def test_device_is_required(argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert "--device" in capsys.readouterr().err


def test_module_entry_point_needs_device():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "jxl_tpu_torch", "bench"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "--device" in out.stderr


def test_unported_options_raise_before_work(tiny_set, tmp_path, monkeypatch):
    """`encode --stripes` and `bench --mesh` run (they were the last two
    unported options); a malformed --mesh and --graph without matplotlib
    still refuse before any work."""
    from jxl_tpu_torch.codec.tiled import is_striped, read_striped

    src = os.path.join(tiny_set, "mini", "im0.png")
    assert main(["encode", src, str(tmp_path / "s.jxt"), "--device", "cpu", "--stripes", "2"]) == 0
    with open(tmp_path / "s.jxt", "rb") as f:
        data = f.read()
    assert is_striped(data) and len(read_striped(data)[2]) == 2
    np.testing.assert_array_equal(decode_file(str(tmp_path / "s.jxt"), device="cpu"), np.asarray(jax_decode_file(str(tmp_path / "s.jxt"))))

    base = ["bench", "--device", "cpu", "--test-image-dir", tiny_set, "--distances", "1", "--efforts", "7"]
    assert main(base + ["--benchmark-dir", str(tmp_path / "mesh"), "--mesh", "data=2"]) == 0
    assert main(base + ["--benchmark-dir", str(tmp_path / "one")]) == 0
    rows = []
    for name in ("mesh", "one"):
        with open(tmp_path / name / "0" / "mini" / "BASELINE" / "results" / "comparisons.csv") as f:
            rows.append(f.read())
    assert rows[0] == rows[1] and len(rows[0].splitlines()) == 3

    bench = str(tmp_path / "bench")
    with pytest.raises(ValueError, match="mesh spec"):
        main(base + ["--benchmark-dir", bench, "--mesh", "rows=2"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on the card's machine
    with pytest.raises(RuntimeError, match="matplotlib"):
        main(base + ["--benchmark-dir", bench, "--graph"])
    assert not os.path.exists(bench)


def test_cuda_device_without_cuda_raises(tiny_set, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for machines without one")
    bench = str(tmp_path / "bench")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["bench", "--device", "cuda:0", "--test-image-dir", tiny_set, "--benchmark-dir", bench])
    assert not os.path.exists(bench)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["encode", os.path.join(tiny_set, "mini", "im0.png"), str(tmp_path / "x.jxt"), "--device", "cuda:0"])
