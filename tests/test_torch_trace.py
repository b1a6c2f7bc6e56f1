"""The codec's stage spans (`jxl_tpu_torch/utils/trace.py`).

On the CPU: nothing is recorded with tracing off; under a Recorder an
encode, a grid encode and a grid decode record their stages with the
stated nesting and request ids; the codec's bytes and pixels do not depend
on tracing; a torch.profiler session turns tracing on and off; the buffer
counts what it drops; `bench --profile` puts the spans into its Chrome
trace on the profiler's time base. On the card (marked `cuda`): the kernels
of an encode and a grid decode lie where the spans say, which holds the
spans' clock to the device trace's.

The file imports neither jax nor the test conftest, so it runs on a machine
without jax:

    python -m pytest tests/test_torch_trace.py --noconftest -o addopts="" -q
"""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.decode import decode_bytes_device, decode_bytes_grid_stacked
from jxl_tpu_torch.codec.encode import encode_image, encode_image_async, encode_image_grid
from jxl_tpu_torch.utils import trace

ENCODE_CHILDREN = {"encode.front_end", "encode.entropy", "encode.screen"}
FRONT_END_CHILDREN = {"encode.acs", "encode.decide", "encode.epf"}
DECODE_CHILDREN = {"decode.read", "decode.scan", "decode.reconstruct"}
DISTANCES = [0.5, 1.0, 3.0]


def _image(h: int = 64, w: int = 96, seed: int = 5) -> np.ndarray:
    """A photographic-like test image: smooth shading, an edge and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    lum = 0.5 + 0.3 * np.sin(xx / 13.0) * np.cos(yy / 9.0) + 0.2 * (xx > w / 2) + rng.normal(0, 0.03, yy.shape)
    return (np.clip(np.stack([lum, lum * 0.85, lum * 0.7], axis=-1), 0, 1) * 255).astype(np.uint8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans against the device trace")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _empty_buffer():
    trace.drain()
    yield
    trace.drain()


def _by_id(spans):
    return {s.span_id: s for s in spans}


def _check_nesting(spans):
    """Every span lies inside its parent, and each stage has the parent the
    layout of the codec gives it."""
    ids = _by_id(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent_id is None:
            continue
        p = ids[s.parent_id]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
        assert s.request_id == p.request_id
        if s.name in ENCODE_CHILDREN:
            assert p.name == "encode"
        elif s.name in FRONT_END_CHILDREN:
            assert p.name == "encode.front_end"
        elif s.name in DECODE_CHILDREN:
            assert p.name == "decode"
    for s in spans:
        if s.name in ("encode", "encode.finalize", "decode"):
            assert s.parent_id is None, s


def test_off_records_nothing():
    assert not trace.tracing()
    img = _image()
    data = encode_image(img, CodecConfig(effort=7), device="cpu")
    decode_bytes_device(data, device="cpu")
    datas = encode_image_grid(img, CodecConfig(effort=7), DISTANCES, device="cpu")
    decode_bytes_grid_stacked(datas, device="cpu")
    assert trace.drain() == [] and trace.dropped() == 0
    assert trace.span("x") is trace.span("y")  # the one shared no-op


def test_encode_and_decode_spans():
    img = _image()
    with trace.Recorder() as rec:
        data = encode_image(img, CodecConfig(effort=7), device="cpu")
        decode_bytes_device(data, device="cpu")
    spans = rec.spans
    names = Counter(s.name for s in spans)
    assert names == {
        "encode": 1, "encode.front_end": 1, "encode.acs": 1, "encode.decide": 5, "encode.epf": 1,
        "encode.entropy": 1, "encode.screen": 1, "encode.finalize": 1,
        "decode": 1, "decode.read": 2, "decode.scan": 1, "decode.reconstruct": 1,
    }
    _check_nesting(spans)
    enc = [s for s in spans if s.name.startswith("encode")]
    dec = [s for s in spans if s.name.startswith("decode")]
    assert len({s.request_id for s in enc}) == 1  # dispatch and finalize: one request
    assert len({s.request_id for s in dec}) == 1 and dec[0].request_id != enc[0].request_id
    root = next(s for s in spans if s.name == "encode")
    fin = next(s for s in spans if s.name == "encode.finalize")
    assert root.end_ns <= fin.start_ns and trace.drain() == []  # a Recorder's spans are its own


def test_grid_spans():
    img = _image()
    with trace.Recorder() as rec:
        datas = encode_image_grid(img, CodecConfig(effort=7), DISTANCES, device="cpu")
        decode_bytes_grid_stacked(datas, device="cpu")
    names = Counter(s.name for s in rec.spans)
    n = len(DISTANCES)
    assert names == {
        "encode": 1, "encode.front_end": n, "encode.acs": n, "encode.decide": 5 * n, "encode.epf": n,
        "encode.entropy": n, "encode.screen": 1, "encode.finalize": 1,
        # the entry's own decode_values_grid call is part of its span
        "decode": 1, "decode.read": 2, "decode.scan": 1, "decode.reconstruct": n,
    }
    _check_nesting(rec.spans)


def test_async_finalize_carries_the_dispatch_request():
    img = _image(32, 48)
    with trace.Recorder() as rec:
        fin_a = encode_image_async(img, CodecConfig(effort=3), device="cpu")
        fin_b = encode_image_async(img, CodecConfig(effort=3, distance=2.0), device="cpu")
        fin_a(), fin_b()
    roots = [s for s in rec.spans if s.parent_id is None]
    assert [s.name for s in roots] == ["encode", "encode", "encode.finalize", "encode.finalize"]
    assert roots[2].request_id == roots[0].request_id and roots[3].request_id == roots[1].request_id
    assert roots[0].request_id != roots[1].request_id


@pytest.mark.parametrize("effort", [3, 7, 9])
def test_bytes_and_pixels_do_not_depend_on_tracing(effort):
    img = _image(seed=effort)
    cfg = CodecConfig(effort=effort)
    off = encode_image(img, cfg, device="cpu"), encode_image_grid(img, cfg, DISTANCES, device="cpu")
    with trace.Recorder() as rec:
        on = encode_image(img, cfg, device="cpu"), encode_image_grid(img, cfg, DISTANCES, device="cpu")
        px_on = decode_bytes_grid_stacked(on[1], device="cpu")
    assert rec.spans and on == off
    assert torch.equal(px_on, decode_bytes_grid_stacked(off[1], device="cpu"))


def test_profiler_turns_tracing_on_and_off():
    from torch.profiler import ProfilerActivity, profile

    assert not trace.tracing()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.tracing()
        with trace.span("outer"):
            with trace.span("inner"):
                pass
    assert not trace.tracing()
    with trace.span("after"):
        pass
    spans = trace.drain()
    assert [s.name for s in spans] == ["inner", "outer"]
    assert spans[0].parent_id == spans[1].span_id and spans[0].request_id == spans[1].request_id


def test_a_span_inside_one_of_its_name_records_nothing():
    with trace.Recorder() as rec:
        with trace.span("decode"):
            with trace.span("decode"):
                with trace.span("decode.read"):
                    pass
    assert [s.name for s in rec.spans] == ["decode.read", "decode"]


def test_the_buffer_counts_drops(monkeypatch):
    with trace.Recorder(capacity=2) as rec:
        for _ in range(5):
            with trace.span("x"):
                pass
    assert len(rec.spans) == 2 and rec.dropped == 3
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(trace, "_BUFFER", trace.Buffer(capacity=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            with trace.span("y"):
                pass
    assert trace.dropped() == 1 and len(trace.spans_between(0, 2**63)) == 3
    assert len(trace.drain()) == 3 and trace.dropped() == 0


def test_threads_keep_their_own_nesting_and_lose_no_count():
    """Eight threads, each recording nested spans into one small Recorder
    with a short switch interval: every span's parent is of its own thread,
    and kept plus dropped spans add up to all of them."""
    import sys
    import threading

    n_threads, n_each = 8, 400
    roots = {}

    def work(k):
        for _ in range(n_each):
            with trace.span(f"t{k}"):
                with trace.span(f"t{k}.inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.Recorder(capacity=n_threads * n_each) as rec:
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == n_threads * n_each and rec.dropped == n_threads * n_each
    ids = _by_id(rec.spans)
    for s in rec.spans:
        if s.parent_id is None:
            roots[s.request_id] = s.name
    for s in rec.spans:
        if s.parent_id is not None and s.parent_id in ids:
            assert ids[s.parent_id].name + ".inner" == s.name
        if s.name.endswith(".inner") and s.request_id in roots:
            assert roots[s.request_id] + ".inner" == s.name


def test_chrome_trace_shares_the_profilers_time_base(tmp_path):
    """An aten op run inside a span lies inside that span's event."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(192, 192)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            torch.mm(x, x)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    assert trace.add_to_chrome_trace(path, trace.drain()) == path
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    (sp,) = [e for e in events if e.get("cat") == "program_span"]
    assert sp["name"] == "outer" and sp["tid"] == trace.SPAN_TID
    assert sp["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"]


def test_chrome_trace_without_a_time_base_gets_spans_json(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": []}))
    with trace.Recorder() as rec:
        with trace.span("x"):
            pass
    out = trace.add_to_chrome_trace(str(path), rec.spans, 4)
    assert out == str(tmp_path / "spans.json")
    doc = json.loads((tmp_path / "spans.json").read_text())
    assert doc["dropped"] == 4 and [s["name"] for s in doc["spans"]] == ["x"]


def test_bench_profile_writes_the_spans(tmp_path):
    from jxl_tpu_torch.cli.main import main
    from jxl_tpu_torch.core.io import write_image

    (tmp_path / "imgs" / "mini").mkdir(parents=True)
    write_image(str(tmp_path / "imgs" / "mini" / "a.png"), _image(32, 40))
    prof = tmp_path / "prof"
    argv = ["bench", "--device", "cpu", "--test-image-dir", str(tmp_path / "imgs"), "--benchmark-dir",
            str(tmp_path / "b"), "--distances", "1", "3", "--efforts", "7", "--profile", str(prof)]
    assert main(argv) == 0
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    names = Counter(e["name"] for e in spans)
    assert names["encode"] == 1 and names["encode.front_end"] == 2 and names["decode"] >= 1
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("name") == "aten::bincount"]
    entropy = [e for e in spans if e["name"] == "encode.entropy"]
    # the entropy stage's histograms lie inside its spans, on one time base
    inside = [o for o in ops if any(s["ts"] <= o["ts"] <= s["ts"] + s["dur"] for s in entropy)]
    assert entropy and len(inside) >= len(entropy)
    assert not os.path.exists(prof / "spans.json")


@pytest.mark.cuda
def test_kernels_lie_in_their_spans_on_the_card():
    """Under torch.profiler with CUDA activity, each B3 kernel of an encode
    lies inside an `encode.entropy` span (its wrapper reads the counts back,
    so the kernel ends inside the span), and each B2 kernel of a grid decode
    starts after the start of its row's `decode.scan` span (a launch returns
    before its kernel ends, so its end is not checked)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    img = _image(256, 384, seed=11)
    cfg = CodecConfig(effort=7)
    rows = [encode_image_grid(img, cfg, DISTANCES, device=dev) for _ in range(2)]  # builds and warms the kernels
    decode_bytes_grid_stacked(rows[0], device=dev)
    torch.cuda.synchronize(dev)
    trace.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        encode_image(img, cfg, device=dev)
        encode_image_grid(img, cfg, DISTANCES, device=dev)
        for datas in rows:
            decode_bytes_grid_stacked(datas, device=dev)
        torch.cuda.synchronize(dev)
    spans = trace.drain()
    kernels = sorted((e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    entropy = [(s.start_ns, s.end_ns) for s in spans if s.name == "encode.entropy"]
    enc = [(s, e) for s, e, n in kernels if "rans_encode_kernel" in n]
    assert len(entropy) == 1 + len(DISTANCES) and len(enc) >= len(entropy)  # an overflow relaunches
    margins = []
    for ks, ke in enc:
        (span,) = [(s, e) for s, e in entropy if s <= ks < e]
        assert ke <= span[1]
        margins.append((ks - span[0], span[1] - ke))
    scans = sorted(s.start_ns for s in spans if s.name == "decode.scan")
    dec = [s for s, _e, n in kernels if "rans_decode_kernel" in n]
    assert len(scans) == len(rows) and len(dec) == 2 * len(rows)
    for i, ks in enumerate(dec):
        assert ks >= scans[i // 2], (i, ks - scans[i // 2])
    print("B3 start-after / end-before margins (ns):", margins)
    print("B2 start after its scan span (ns):", [ks - scans[i // 2] for i, ks in enumerate(dec)])


@pytest.mark.parametrize("where", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_containers_equal_with_tracing_on_and_off(where):
    """The same containers and pixels with a profiler session on as off."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card() if where == "cuda" else torch.device("cpu")
    img = _image(96, 128, seed=2)
    cfg = CodecConfig(effort=7)

    def run():
        data = encode_image(img, cfg, device=dev)
        return data, decode_bytes_device(data, device=dev).cpu()

    off = run()
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts):
        on = run()
    assert trace.drain() and on[0] == off[0] and torch.equal(on[1], off[1])
