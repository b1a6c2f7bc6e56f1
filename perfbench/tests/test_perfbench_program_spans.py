"""The readers of the program's stage spans (`perfbench/program_spans.py`):
self-time arithmetic on synthetic nested spans, no reading where there is
nothing to read, and every stage metric found in its cells and reported by
a traced run of the tiny cells on the CPU."""

import importlib.util
import json
import sys
import time
from pathlib import Path

import pytest

from perfbench import harness, program_spans
from perfbench.trace import Trace

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
STEMS = ("front_end", "acs", "decide", "epf", "entropy", "screen", "finalize")
DEC_STEMS = ("read", "scan", "reconstruct")
NEW = {
    "kodak_768x512.roundtrip": [f"latency.enc.{s}_ms" for s in STEMS],
    "photo_12mp.roundtrip": [f"codec.enc.{s}_ms" for s in STEMS],
    "kodak_768x512.rd_sweep": [f"sweep.enc.{s}_ms" for s in STEMS] + [f"sweep.dec.{s}_ms" for s in DEC_STEMS],
}
NAMES = [n for names in NEW.values() for n in names]
MS = 1_000_000


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"r_{name}", ROOT / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, s, e, sid, parent=None, request=1):
    from jxl_tpu_torch.utils.trace import Span

    return Span(name, s * MS, e * MS, sid, parent, request)


# one encode of 100 ms: front end 10-60 holding the ACS search 15-35 and two
# decisions 40-42 and 50-55; entropy 60-90; screen 92-94; a finalize root
# 100-110 holding a decode 102-106 (a mode pick)
SPANS = [
    _span("encode", 0, 100, 1),
    _span("encode.front_end", 10, 60, 2, 1),
    _span("encode.acs", 15, 35, 3, 2),
    _span("encode.decide", 40, 42, 4, 2),
    _span("encode.decide", 50, 55, 5, 2),
    _span("encode.entropy", 60, 90, 6, 1),
    _span("encode.screen", 92, 94, 7, 1),
    _span("encode.finalize", 100, 110, 8),
    _span("decode", 102, 106, 9, 8),
]


def _trace(kernels=(), units=2, outside=((0, 110),)):
    spans = [("window", 0, 1000 * MS)] + [("encode", s * MS, e * MS) for s, e in outside]
    return Trace(spans=spans, device_ops=list(kernels), counters={"units": units})


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(program_spans, "spans", lambda trace: list(SPANS))


def test_self_time_is_the_span_less_its_children():
    own = program_spans.self_intervals(SPANS)
    total = {name: sum(e - s for s, e in parts) / MS for name, parts in own.items()}
    assert total == {"encode": 100 - 50 - 30 - 2, "encode.front_end": 50 - 20 - 2 - 5, "encode.acs": 20,
                     "encode.decide": 7, "encode.entropy": 30, "encode.screen": 2, "encode.finalize": 6,
                     "decode": 4}
    assert own["encode.front_end"] == [(10 * MS, 15 * MS), (35 * MS, 40 * MS), (42 * MS, 50 * MS),
                                       (55 * MS, 60 * MS)]


def test_readers_divide_by_units(synthetic):
    tr = _trace(units=2)
    assert _reader("latency.enc.front_end_ms")(tr) == pytest.approx(23 / 2)
    assert _reader("codec.enc.decide_ms")(tr) == pytest.approx(3.5)
    assert _reader("sweep.enc.finalize_ms")(tr) == pytest.approx(3.0)
    assert _reader("sweep.dec.scan_ms")(tr) is None  # no such span


def test_stage_table_and_coverage(synthetic):
    kernels = [("k", 20 * MS, 30 * MS), ("k", 36 * MS, 38 * MS), ("Memcpy DtoH (Device -> Pageable)", 41 * MS,
                                                                   41 * MS + 10), ("Memcpy HtoD", 1 * MS, 2 * MS)]
    tr = _trace(kernels, units=1, outside=((0, 112),))
    table = program_spans.stage_table(tr)
    assert table["encode.front_end"] == {"spans": 1, "self_ms": 23.0, "idle_ms": 21.0, "kernels": 1,
                                         "dtoh": 0, "htod": 0}
    assert table["encode.decide"]["dtoh"] == 1 and table["encode.decide"]["spans"] == 2
    assert table["encode"]["htod"] == 1 and table["encode.acs"]["idle_ms"] == 10.0
    accounted, idle_share = program_spans.encode_coverage(tr)
    assert accounted == pytest.approx((18 + 23 + 20 + 7 + 30 + 2 + 6) / 112)  # the pick's decode is not the encoder's
    assert idle_share == pytest.approx((110 - 12) / (112 - 12))  # idle 110-112 is outside the program's spans


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_with_nothing_to_read_returns_nothing(name, monkeypatch):
    """No unit, no span, a dropped span, or a program without the tracer:
    no reading, never a 0."""
    from jxl_tpu_torch.utils import trace as tracer

    empty = Trace(spans=[("window", 0, 1000 * MS)], device_ops=[], counters={"units": 0})
    assert _reader(name)(empty) is None
    tr = Trace(spans=[("window", 0, 1000 * MS)], device_ops=[], counters={"units": 3})
    monkeypatch.setattr(tracer, "_BUFFER", tracer.Buffer())
    assert _reader(name)(tr) is None
    tracer._BUFFER.raw = [tuple(s) for s in SPANS] + [("decode.read", 200 * MS, 201 * MS, 10, None, 2),
                                                     ("decode.scan", 202 * MS, 203 * MS, 11, None, 2),
                                                     ("decode.reconstruct", 203 * MS, 209 * MS, 12, None, 2),
                                                     ("encode.epf", 210 * MS, 211 * MS, 13, None, 3)]
    assert _reader(name)(tr) is not None
    tracer._BUFFER.dropped = 1
    assert _reader(name)(tr) is None
    tracer._BUFFER.dropped = 0
    # the import fails, as in a parent that has no tracer
    monkeypatch.delattr(sys.modules["jxl_tpu_torch.utils"], "trace")
    monkeypatch.setitem(sys.modules, "jxl_tpu_torch.utils.trace", None)
    assert _reader(name)(tr) is None


def test_every_stage_metric_resolves_in_its_cells():
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for cell, names in NEW.items():
        resolved = {m["name"] for m in harness.resolve(REPO, manifest, cell).per_layer}
        assert set(names) <= resolved
        for name in names:
            m = entries[name]
            assert m["source"] == "program_span" and m["workloads"] == [cell]
            assert m["layer"] == ("decoder" if ".dec." in name else "encoder")
    assert len(NAMES) == 24


@pytest.mark.parametrize("cell", ["tiny.rd_sweep", "tiny.roundtrip"])
def test_a_traced_run_reports_every_stage_metric(tiny_root, cell):
    c = harness.resolve(tiny_root, harness.load_manifest(tiny_root), cell)
    r = harness.run_cell(c, seed=2**31 + 41, seconds=1.5, trace=True, device="cpu", t_start=time.perf_counter())
    names = NEW[cell.replace("tiny", "kodak_768x512")]
    assert all(isinstance(r["metrics"][n]["value"], float) for n in names)
    enc = sum(r["metrics"][n]["value"] for n in names if ".enc." in n)
    outside = r["metrics"]["sweep.encode_ms" if cell.endswith("sweep") else "latency.encode_ms"]["value"]
    assert enc <= outside
