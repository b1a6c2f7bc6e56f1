"""BENCHMARK.json against the benchmark's contract, and the harness finding
every piece by name."""

import json
import re
import time
from pathlib import Path

import pytest

from perfbench import harness

REPO = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    assert manifest["paths"] == ["perfbench"]
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024
    n = len(manifest["workloads"])
    assert (2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= n <= 24


def test_names_units_and_lines(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert {m["name"] for m in manifest["end_to_end"]} >= {"setup_s"}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_resolves_and_reports(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    used = set()
    for w in manifest["workloads"]:
        cell = harness.resolve(REPO, manifest, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        assert set(cell.config["correct_limits"])
        used.add(w["config"])
    assert used == {c["name"] for c in manifest["configs"]}


NEW_LOOP = """
from perfbench.load import Request, codec


class Loop:
    \"\"\"Round trips of every `stride`-th image, encoded from the device tensor.\"\"\"

    def __init__(self, cfg, mix, images, dev):
        config, _e, _d, _b = codec()
        self.c = cfg["codec"]
        self.cfg = config.CodecConfig(distance=float(self.c["distance"]), effort=int(self.c["effort"]),
                                      strategy=config.Strategy[self.c["strategy"]])
        self.images, self.dev, self.stride, self.next = images, dev, int(mix["stride"]), 0

    def warm(self):
        pass

    def step(self, win, sample):
        _c, encode, decode, _b = codec()
        i = (self.next * self.stride) % len(self.images)
        self.next += 1
        win.attempted += 1
        data = encode.encode_image(self.images[i].cpu().numpy(), self.cfg, device=self.dev)
        pixels = decode.decode_bytes_device(data, device=self.dev)
        win.units += 1
        win.megapixels += self.images[i].shape[0] * self.images[i].shape[1] / 1e6
        win.containers.append(data)
        sample.offer(lambda: Request(i, float(self.c["distance"]), int(self.c["effort"]), self.c["strategy"],
                                     data, pixels))
"""

NEW_SOURCE = """
import torch

from perfbench.sources.synth_photo import image_seed, synth_photo


def images(spec, seed, device):
    h, w = int(spec["height"]), int(spec["width"])
    return [torch.flip(synth_photo(h, w, image_seed(seed, i), device), dims=[1]) for i in range(int(spec["count"]))]
"""


def test_a_new_config_source_loop_mix_metric_and_cell_need_no_edit(tiny_root):
    """Only new files and new entries: a configuration under another
    strategy with its own image source, a mix driving a new loop, an
    end-to-end and a per-layer metric are resolved by name, and the new
    cell runs whole and is judged against its own strategy's front end."""
    cfg = json.loads((tiny_root / "perfbench/configs/tiny.json").read_text())
    cfg.update(name="dummy", judge="vardct")
    cfg["images"]["source"] = "flipped_photo"
    cfg["codec"]["strategy"] = "COMBINED"
    (tiny_root / "perfbench/configs/dummy.json").write_text(json.dumps(cfg))
    (tiny_root / "perfbench/sources/flipped_photo.py").write_text(NEW_SOURCE)
    (tiny_root / "perfbench/loops/strided.py").write_text(NEW_LOOP)
    (tiny_root / "perfbench/traffic/dummy_mix.json").write_text(json.dumps({"loop": "strided", "stride": 2}))
    (tiny_root / "perfbench/metrics/dummy.layer_ms.py").write_text("def read(trace):\n    return 1.5\n")
    (tiny_root / "perfbench/end_to_end/dummy_rate.py").write_text(
        "def read(run):\n    return run.window.units / run.window.seconds\n")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "dummy", "source": "https://example.org", "file": "perfbench/configs/dummy.json",
                         "reduced": [], "why": "dummy"})
    m["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy", "traffic": "dummy_mix", "chips": 1,
                           "why": "dummy"})
    m["end_to_end"].append({"name": "dummy_rate", "unit": "1/s", "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["dummy.dummy_mix"]})
    m["per_layer"].append({"name": "dummy.layer_ms", "unit": "ms", "better": "lower", "source": "program_span",
                           "layer": "dummy", "moves": "dummy_rate", "workloads": ["dummy.dummy_mix"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.resolve(tiny_root, harness.load_manifest(tiny_root), "dummy.dummy_mix")
    assert cell.config["name"] == "dummy" and cell.mix["loop"] == "strided"
    assert {x["name"] for x in cell.end_to_end} == {"dummy_rate", "setup_s"}
    assert [x["name"] for x in cell.per_layer] == ["dummy.layer_ms"]
    r = harness.run_cell(cell, seed=2**31 + 29, seconds=1.0, trace=False, device="cpu", t_start=time.perf_counter())
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"dummy_rate", "setup_s"} and r["metrics"]["dummy_rate"]["value"] > 0
    assert r["compared"]["encode_mismatch"]["value"] == 0.0
    r = harness.run_cell(cell, seed=2**31 + 29, seconds=1.0, trace=True, device="cpu", t_start=time.perf_counter())
    assert r["metrics"] == {"dummy.layer_ms": {"value": 1.5, "unit": "ms"}}


def test_a_missing_piece_is_named(tiny_root):
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tiny.nowhere", "config": "tiny", "traffic": "nowhere", "chips": 1, "why": "x"})
    with pytest.raises(harness.CellError, match="nowhere"):
        harness.resolve(tiny_root, m, "tiny.nowhere")
    m["workloads"][-1]["traffic"] = "roundtrip"
    cfg = json.loads((tiny_root / "perfbench/configs/tiny.json").read_text())
    for key, value, missing in (("judge", "modular", "judges/modular"), ("images", {"source": "kodak_png"},
                                                                          "sources/kodak_png")):
        bad = dict(cfg, **{key: value})
        (tiny_root / "perfbench/configs/tiny.json").write_text(json.dumps(bad))
        with pytest.raises(harness.CellError, match=missing):
            harness.resolve(tiny_root, m, "tiny.nowhere")
    with pytest.raises(harness.CellError, match="no workload"):
        harness.resolve(tiny_root, m, "absent.cell")
