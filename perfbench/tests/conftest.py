"""Fixtures of the benchmark's own tests (`python -m pytest perfbench/tests`).

`tiny_root` is a checkout-like directory holding this repository's
BENCHMARK.json and perfbench/ data plus a tiny configuration ("tiny",
3 images of 64x96, a 3-distance x 2-effort grid) and its two cells, so that
a whole run fits in a test on the CPU.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"height": 64, "width": 96, "count": 3}


def make_tiny_root(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dst / "perfbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((dst / "BENCHMARK.json").read_text())
    cfg = json.loads((dst / "perfbench/configs/kodak_768x512.json").read_text())
    cfg["name"] = "tiny"
    cfg["images"].update(TINY)
    cfg["grid"] = {"distances": [0.5, 3.0, 14.0], "efforts": [5, 9]}
    (dst / "perfbench/configs/tiny.json").write_text(json.dumps(cfg))
    m["configs"].append({"name": "tiny", "source": "https://example.org/tiny", "file": "perfbench/configs/tiny.json",
                         "reduced": [], "why": "a test-sized copy of kodak_768x512"})
    m["workloads"] += [
        {"name": "tiny.rd_sweep", "config": "tiny", "traffic": "rd_sweep", "chips": 1, "why": "test"},
        {"name": "tiny.roundtrip", "config": "tiny", "traffic": "roundtrip", "chips": 1, "why": "test"},
    ]
    for e in m["end_to_end"] + m["per_layer"]:
        if "workloads" in e:
            e["workloads"] += [w.replace("kodak_768x512", "tiny") for w in e["workloads"] if w.startswith("kodak")]
    (dst / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
