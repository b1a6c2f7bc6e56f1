"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: `jxl_tpu_torch` begins with `jxl_tpu` and is not it."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "jxl_tpu"}


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT / "reference")))
def test_reference_imports_nothing_of_the_program(path):
    assert "jxl_tpu_torch" not in _imports(path)
    assert _imports(path) <= {"__future__", "math", "dataclasses", "functools", "contextlib", "struct",
                              "numpy", "torch", "perfbench"}


def test_whole_names_are_compared():
    assert "jxl_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    """The harness, the loops and the reference, imported in a fresh
    interpreter with the program, leave no forbidden module loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.harness, perfbench.load, perfbench.reference.judges.vardct, perfbench.calibrate\n"
        "import perfbench.loops.roundtrip, perfbench.loops.sweep_rows, perfbench.sources.synth_photo\n"
        "import jxl_tpu_torch.codec.encode, jxl_tpu_torch.codec.decode, jxl_tpu_torch.metrics.battery\n"
        "from perfbench.harness import forbidden_loaded\n"
        "assert forbidden_loaded() == [], forbidden_loaded()\n"
    ) % str(ROOT.parent)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
