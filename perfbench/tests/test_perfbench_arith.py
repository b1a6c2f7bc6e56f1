"""The yardstick's arithmetic on synthetic numbers."""

import importlib.util
from pathlib import Path

import pytest

from perfbench import load, yardstick
from perfbench.harness import Run
from perfbench.trace import Trace, breakdown

ROOT = Path(__file__).resolve().parents[1]


def _reader(kind, name):
    spec = importlib.util.spec_from_file_location(f"r_{name}", ROOT / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_union_of_intervals():
    assert yardstick.union_ns([]) == 0
    assert yardstick.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert yardstick.union_ns([(0, 100), (10, 20), (30, 40)]) == 100
    assert yardstick.union_ns([(5, 5), (7, 6)]) == 0
    assert yardstick.merged([(20, 30), (0, 10), (5, 15)]) == [(0, 15), (20, 30)]


def test_p95_is_over_all_requests():
    values = list(range(1, 101))  # 1..100 ms
    assert yardstick.percentile(values, 95) == pytest.approx(95.05)
    assert yardstick.percentile([7.0], 95) == 7.0
    win = load.Window(seconds=2.0, encode_ms=[10.0] * 95 + [100.0] * 5)
    assert _reader("end_to_end", "encode_p95_ms")(Run(win, 1.0)) == pytest.approx(14.5)  # between rank 94 (10 ms) and 95 (100 ms)
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def test_rates_are_all_work_over_all_time():
    win = load.Window(seconds=4.0, units=30, megapixels=12.0)
    assert _reader("end_to_end", "sweep_points_per_s")(Run(win, 1.0)) == 7.5
    assert _reader("end_to_end", "codec_mps")(Run(win, 1.0)) == 3.0
    assert _reader("end_to_end", "setup_s")(Run(win, 17.5)) == 17.5


def test_byte_formulas_on_fixed_shapes():
    # lanes 256 (G = 2), T = 10, 100 words, 50 mantissa bytes
    assert yardstick.encode_bytes(10, 256, 100, 50) == 4 * (2 * 10 * 256 + 10 * 128 + 100 + 50 + 256 + 4)
    assert yardstick.decode_bytes(10, 256, 100, 50) == 4 * (10 * 128 + 100 + 50 + 256 + 4 + 10 * 256 + 256 + 4)


def _trace(kernels, spans, units=4, containers=()):
    return Trace(spans=[("window", 0, 1_000_000_000)] + spans, device_ops=kernels,
                 counters={"units": units, "host_syncs": 151}, containers=list(containers))


def test_idle_share_and_per_unit_spans():
    tr = _trace(
        [("k1", 0, 100_000_000), ("k2", 50_000_000, 250_000_000), ("Memcpy HtoD", 300_000_000, 900_000_000)],
        [("encode", 0, 600_000_000), ("decode", 600_000_000, 1_000_000_000)],
    )
    assert tr.busy_ns() == 250_000_000  # the copy is not a kernel
    assert _reader("metrics", "codec.device_idle")(tr) == pytest.approx(75.0)
    assert _reader("metrics", "codec.device_busy_ms")(tr) == pytest.approx(62.5)
    assert _reader("metrics", "sweep.device_busy_ms")(tr) == pytest.approx(62.5)
    assert _reader("metrics", "codec.encode_ms")(tr) == pytest.approx(150.0)
    assert _reader("metrics", "codec.decode_ms")(tr) == pytest.approx(100.0)
    assert _reader("metrics", "codec.kernels")(tr) == 0.5
    assert _reader("metrics", "codec.host_syncs")(tr) == 151
    assert _reader("metrics", "sweep.encode_ms")(tr) == pytest.approx(150.0)
    assert _reader("metrics", "latency.host_syncs")(tr) == 151
    b = breakdown(tr)
    assert b["device_ops"][0] == ["Memcpy HtoD", 0.6]
    assert dict(b["idle_gaps"]) == {"encode": pytest.approx(0.35), "decode": pytest.approx(0.4)}


def test_encode_span_readers():
    """Kernels inside the encode spans only: 2 encodes of 200 ms, kernels 50 ms in
    the first and 30 ms in the second (one of them ending after its span), and 400 ms
    of kernels in the decode span, which these readers do not count."""
    tr = _trace(
        [("k1", 10_000_000, 40_000_000), ("k2", 20_000_000, 60_000_000), ("k3", 380_000_000, 420_000_000),
         ("Memcpy HtoD", 300_000_000, 350_000_000), ("k4", 500_000_000, 900_000_000)],
        [("encode", 0, 200_000_000), ("encode", 200_000_000, 400_000_000), ("decode", 400_000_000, 1_000_000_000)],
        units=2,
    )
    tr.counters["megapixels"] = 3.0
    assert tr.busy_in_ns("encode") == 70_000_000
    assert tr.kernels_in("encode") == 3
    assert _reader("metrics", "latency.encode_ms")(tr) == pytest.approx(200.0)
    assert _reader("metrics", "latency.encode_busy_ms")(tr) == pytest.approx(35.0)
    assert _reader("metrics", "latency.encode_idle")(tr) == pytest.approx(82.5)
    assert _reader("metrics", "latency.encode_kernels")(tr) == 1.5
    assert _reader("metrics", "latency.codec_mps")(tr) == pytest.approx(3.0)


def test_roofline_share(monkeypatch):
    """bytes / peak over the kernels' union: 3.35 GB in 2 s of kernel is 50%."""
    from perfbench import streams

    monkeypatch.setattr(streams, "shape", lambda data: data)
    monkeypatch.setattr(yardstick, "encode_bytes", lambda T, lanes, w, m: T)
    tr = _trace([("rans_encode_kernel", 0, 1_000_000_000), ("rans_encode_kernel", 500_000_000, 2_000_000_000),
                 ("other", 0, 2_000_000_000)], [], containers=[(1.675e9, 0, 0, 0), (1.675e9, 0, 0, 0)])
    tr.spans[0] = ("window", 0, 3_000_000_000)
    assert _reader("metrics", "rans_enc_roofline")(tr) == pytest.approx(100.0 * (3.35e9 / 3.35e12) / 2.0)
    assert _reader("metrics", "rans_enc_roofline.latency")(tr) == _reader("metrics", "rans_enc_roofline")(tr)
    assert _reader("metrics", "rans_dec_roofline")(tr) is None  # no decode kernel in the window


def test_reservoir_is_drawn_from_the_seed():
    def draw(seed, n):
        r = load.Reservoir(5, seed)
        for i in range(n):
            r.offer(lambda i=i: i)
        return r.items

    assert draw(3, 3) == [0, 1, 2]
    assert draw(2**31 + 9, 400) == draw(2**31 + 9, 400)
    assert draw(1, 400) != draw(2, 400)
    assert len(draw(1, 400)) == 5


@pytest.mark.parametrize("name", ["sweep.encode_ms", "sweep.decode_ms", "sweep.battery_ms", "sweep.device_idle",
                                  "sweep.device_busy_ms", "codec.encode_ms", "codec.decode_ms", "codec.kernels",
                                  "codec.device_idle", "codec.device_busy_ms", "codec.host_syncs",
                                  "rans_enc_roofline", "rans_dec_roofline", "latency.codec_mps",
                                  "latency.encode_ms", "latency.encode_busy_ms", "latency.encode_idle",
                                  "latency.encode_kernels", "latency.host_syncs", "rans_enc_roofline.latency"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    """No work and no kernels in the window: no reading, never a 0."""
    tr = Trace(spans=[("window", 0, 1_000_000_000)], device_ops=[], counters={"units": 0})
    assert _reader("metrics", name)(tr) is None
