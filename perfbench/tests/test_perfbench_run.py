"""The command itself: without a card it prints no result and fails."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def _run(cwd, *extra):
    cmd = [sys.executable, "perfbench/run.py", "--workload", "kodak_768x512.roundtrip", "--seed", str(2**31 + 3),
           "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result(card_absent):
    p = _run(REPO)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_alone_in_a_directory_it_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_an_unknown_cell_fails():
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "nowhere", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
