"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: each fault
that the cells can have must come out as not correct."""

import sys
import time

import pytest
import torch

from perfbench import harness

SECONDS = 1.5


def run(root, cell, trace=False):
    c = harness.resolve(root, harness.load_manifest(root), cell)
    return harness.run_cell(c, seed=2**31 + 17, seconds=SECONDS, trace=trace, device="cpu",
                            t_start=time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny.rd_sweep", "tiny.roundtrip"])
def test_a_sound_run_is_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "compared"
    assert all(v["value"] <= v["limit"] for v in r["compared"].values())
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2


def test_a_traced_run_reports_the_per_layer_metrics(tiny_root):
    r = run(tiny_root, "tiny.rd_sweep", trace=True)
    assert r["correct"] is True
    assert {"sweep.encode_ms", "sweep.decode_ms", "sweep.battery_ms"} <= set(r["metrics"])
    assert r["device"]["window_s"] >= SECONDS and "breakdown" in r


def _flip_a_word(mod):
    """The rANS encode's output with one word of group 0 altered."""
    orig = mod.encode_grouped_cuda

    def broken(*args, **kw):
        words, mbytes, states, wcounts, mcounts = orig(*args, **kw)
        words = words.clone()
        words[0, words.shape[1] - int(wcounts[0]) // 2 - 1] ^= 0x55
        return words, mbytes, states, wcounts, mcounts

    return broken


def _plus_one(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        return None if out is None else torch.clamp(out.to(torch.int16) + 1, 0, 255).to(torch.uint8)

    return broken


def _half_the_row(fn):
    def broken(rgb, cfg, distances, *args, **kw):
        half = list(distances)[: max(1, len(distances) // 2)]
        out = fn(rgb, cfg, half, *args, **kw)
        return (out * len(distances))[: len(distances)]

    return broken


def _battery_shifted(fn):
    def broken(*args, **kw):
        fin = fn(*args, **kw)

        def finalize():
            rows = fin()
            for r in rows:
                r["ssim"] += 1e-3
            return rows

        return finalize

    return broken


def _fails_on_the_second_call(fn):
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        if len(calls) == 4:  # the warm-up makes the first calls
            raise RuntimeError("planted failure")
        return fn(*args, **kw)

    return broken


FAULTS = {
    # an answer altered where it is produced: the encode kernel's words
    "encode_word": ("jxl_tpu_torch.codec.encode", "encode_grouped_cuda", _flip_a_word, None),
    # the decoder's pixels off by one level
    "decode_pixels_rt": ("jxl_tpu_torch.codec.decode", "decode_bytes_device", None, _plus_one),
    "decode_pixels_row": ("jxl_tpu_torch.codec.decode", "decode_bytes_grid_stacked", None, _plus_one),
    # half of the batch left out: a sweep row coded at half its distances
    "half_row": ("jxl_tpu_torch.codec.encode", "encode_image_grid", None, _half_the_row),
    # a battery column altered
    "battery": ("jxl_tpu_torch.metrics.battery", "metric_battery_grid_async", None, _battery_shifted),
    # a request that never answers
    "failure": ("jxl_tpu_torch.codec.encode", "encode_image", None, _fails_on_the_second_call),
}
CASES = [("encode_word", "tiny.roundtrip"), ("encode_word", "tiny.rd_sweep"), ("decode_pixels_rt", "tiny.roundtrip"),
         ("decode_pixels_row", "tiny.rd_sweep"), ("half_row", "tiny.rd_sweep"), ("battery", "tiny.rd_sweep"),
         ("failure", "tiny.roundtrip")]


@pytest.mark.parametrize("fault,cell", CASES, ids=[f"{f}-{c}" for f, c in CASES])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault, cell):
    modname, attr, on_module, on_fn = FAULTS[fault]
    __import__(modname)
    mod = sys.modules[modname]
    broken = on_module(mod) if on_module else on_fn(getattr(mod, attr))
    monkeypatch.setattr(mod, attr, broken)
    r = run(tiny_root, cell)
    assert r["correct"] is False
    if fault == "failure":
        assert r["failed"] == 1
    else:
        assert any(v["value"] > v["limit"] for v in r["compared"].values())
