"""The A/B cell (`ab_homogeneity` mix, `ab_rows` loop) at a test size on the
CPU: its rows come image-major, efforts next and the strategies innermost,
each judged request carrying its row's strategy; a sound traced run of the
tiny copy is `correct` under the configuration's limits and reports the
homogeneity hooks' self time beside the ACS search's; an encode-kernel
fault under the hooks is not correct."""

import json
import sys
import time

import pytest
import torch

from perfbench import harness, load

CELL = "tiny.ab_homogeneity"
SEED = 2**31 + 31


def add_ab_cell(root):
    """The tiny copy of `kodak_768x512.ab_homogeneity`; the tiny root's
    metric lists name it already (`conftest.py` renames the kodak cells)."""
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": CELL, "config": "tiny", "traffic": "ab_homogeneity", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return harness.resolve(root, harness.load_manifest(root), CELL)


def test_rows_are_image_major_with_the_strategies_innermost(tiny_root, monkeypatch):
    cell = add_ab_cell(tiny_root)
    images = harness.images_of(cell, SEED, "cpu")
    loop = harness.make_loop(cell, images, torch.device("cpu"))
    strategies = cell.mix["strategies"]
    assert strategies == ["HOMOGENEITY_PARTITIONING", "HOMOGENEITY_FACTORED_ENTROPY", "COMBINED"]
    n = len(cell.config["grid"]["distances"])
    calls = []

    def row(self, i, e):
        calls.append((i, e, self.strategy))
        return [b"%d" % len(calls)] * n, torch.zeros(n, 1, 1, 3, dtype=torch.uint8), [{}] * n

    mod = sys.modules[type(loop.loops[0]).__module__]
    monkeypatch.setattr(mod.Loop, "_row", row)
    loop.warm()
    efforts = cell.config["grid"]["efforts"]
    assert sorted(calls) == sorted((0, e, s) for e in efforts for s in strategies)
    calls.clear()
    win, sample = load.Window(), load.Reservoir(1000, SEED)
    for _ in range(8):
        loop.step(win, sample)
    order = [(i, e, s) for i in range(len(images)) for e in efforts for s in strategies]
    assert calls == order[:8]
    assert win.units == win.attempted == 8 * n and len(win.containers) == 8 * n
    assert [(r.image, r.effort, r.strategy) for r in sample.items] == [c for c in calls for _ in range(n)]


def test_a_sound_traced_run_is_correct_and_reads_the_hooks(tiny_root):
    cell = add_ab_cell(tiny_root)
    assert {m["name"] for m in cell.end_to_end} == {"sweep_points_per_s", "setup_s"}
    r = harness.run_cell(cell, seed=SEED, seconds=1.5, trace=True, device="cpu", t_start=time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["compared"]) == {"encode_mismatch", "decode_mismatch", "battery_gap"}
    for name in ("ab.encode_ms", "ab.decode_ms", "ab.battery_ms", "ab.enc.homogeneity_ms", "ab.enc.acs_ms"):
        assert isinstance(r["metrics"][name]["value"], float), name
    assert 0 < r["metrics"]["ab.enc.homogeneity_ms"]["value"] < r["metrics"]["ab.encode_ms"]["value"]


def _flip_a_word(orig):
    """The rANS encode's output with one word of group 0 altered."""

    def broken(*args, **kw):
        words, mbytes, states, wcounts, mcounts = orig(*args, **kw)
        words = words.clone()
        words[0, words.shape[1] - int(wcounts[0]) // 2 - 1] ^= 0x55
        return words, mbytes, states, wcounts, mcounts

    return broken


def test_an_encode_fault_under_the_hooks_is_not_correct(tiny_root, monkeypatch):
    from jxl_tpu_torch.codec import encode

    cell = add_ab_cell(tiny_root)
    monkeypatch.setattr(encode, "encode_grouped_cuda", _flip_a_word(encode.encode_grouped_cuda))
    r = harness.run_cell(cell, seed=SEED, seconds=1.0, trace=False, device="cpu", t_start=time.perf_counter())
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["compared"].values())
