"""The striped cell and its judge at a test size on the CPU: a 64x768 image in
3 stripes (the mix's `stripe_mp` set small). A sound traced run of the cell
is `correct` and reports the striped stage metrics; the judge reads 0 for the
program's round trip and holds each fault of the striped path to `correct`
false: a flipped rANS word in the middle section, two equal-width sections
swapped in the wrapper, pixels stitched with EPF run per section (replicated
seam edges) instead of over the run, and one stripe off by one level."""

import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.reference.container import read_container, write_container
from perfbench.reference.judges import striped as judge
from perfbench.reference.striped import STRIPED_MAGIC, read_striped
from perfbench.trace import Trace

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny_striped.striped"
STRIPE_MP = 0.02  # 64x768 = 0.049 MP: 3 stripes of 256 px
SEED = 2**31 + 17  # its first image signals EPF in all three stripes at d = 1
STAGES = ["striped.encode_ms", "striped.decode_ms", "striped.enc.screen_ms", "striped.enc.front_end_ms",
          "striped.enc.acs_ms", "striped.enc.entropy_ms", "striped.dec.scan_ms", "striped.dec.reconstruct_ms",
          "striped.dec.stitch_ms"]
DEVICE = ["striped.device_busy_ms", "striped.device_idle", "rans_enc_roofline.striped", "rans_dec_roofline.striped"]


def add_striped_cell(root):
    """A test-sized copy of `photo_102mp.striped` in a tiny root: its
    configuration at 64x768, a mix with 3 stripes, and the cell in every list
    that names the real one."""
    cfg = json.loads((root / "perfbench/configs/photo_102mp.json").read_text())
    cfg["name"] = "tiny_striped"
    cfg["images"].update(height=64, width=768, count=2)
    (root / "perfbench/configs/tiny_striped.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "perfbench/traffic/striped.json").read_text())
    (root / "perfbench/traffic/tiny_striped.json").write_text(json.dumps(dict(mix, stripe_mp=STRIPE_MP)))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny_striped", "source": "https://example.org/tiny",
                         "file": "perfbench/configs/tiny_striped.json", "reduced": [], "why": "test"})
    m["workloads"].append({"name": CELL, "config": "tiny_striped", "traffic": "tiny_striped", "chips": 1,
                           "why": "test"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "photo_102mp.striped" in e.get("workloads", []):
            e["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return cfg


def test_a_sound_traced_run_is_correct_and_reports_the_stages(tiny_root):
    add_striped_cell(tiny_root)
    cell = harness.resolve(tiny_root, harness.load_manifest(tiny_root), CELL)
    assert {m["name"] for m in cell.end_to_end} == {"codec_mps", "setup_s"}
    assert set(STAGES + DEVICE) <= {m["name"] for m in cell.per_layer}
    r = harness.run_cell(cell, seed=SEED, seconds=1.0, trace=True, device="cpu", t_start=time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(isinstance(r["metrics"][n]["value"], float) for n in STAGES)
    # no kernel runs on the CPU: the device readings have nothing to read
    assert not set(DEVICE) & set(r["metrics"])
    assert r["metrics"]["striped.enc.screen_ms"]["value"] < r["metrics"]["striped.encode_ms"]["value"]


@pytest.mark.parametrize("name", STAGES + DEVICE)
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    """No unit; and, but for the benchmark's own `encode` and `decode`
    spans, no kernel or no program span of that name, as on a program
    without the span: no reading, never a 0."""
    read = harness.reader(REPO, "metrics", name)
    assert read(Trace(spans=[("window", 0, 10**9)], device_ops=[], counters={"units": 0})) is None
    if name not in ("striped.encode_ms", "striped.decode_ms"):
        assert read(Trace(spans=[("window", 0, 10**9)], device_ops=[], counters={"units": 2})) is None


@pytest.fixture(scope="module")
def trip():
    """One program round trip of the tiny cell's first image, its limits and
    the judge's point."""
    from jxl_tpu_torch.codec import tiled
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes_device

    from perfbench.sources.synth_photo import image_seed, synth_photo

    cfg = json.loads((REPO / "perfbench/configs/photo_102mp.json").read_text())
    orig = synth_photo(64, 768, image_seed(SEED, 0), "cpu")
    n = tiled.default_n_stripes(64, 768, STRIPE_MP)
    c = cfg["codec"]
    data = tiled.encode_image_striped(orig.numpy(), CodecConfig(distance=c["distance"], effort=c["effort"]),
                                      n_stripes=n, device="cpu")
    pixels = decode_bytes_device(data, device="cpu")
    return orig, data, pixels, cfg


def _point(trip, data=None, pixels=None):
    orig, data0, pixels0, cfg = trip
    c = cfg["codec"]
    return judge.Point(orig, c["distance"], c["effort"], pixels0 if pixels is None else pixels, c["strategy"],
                       container=data0 if data is None else data)


def _decode(data):
    from jxl_tpu_torch.codec.decode import decode_bytes_device

    return decode_bytes_device(data, device="cpu")


def _rewrap(data, edit):
    """The wrapper with its sections list edited by `edit`."""
    from jxl_tpu_torch.codec.tiled import write_striped

    h, w, secs = read_striped(data)
    secs = list(secs)
    edit(secs)
    return write_striped(h, w, secs)


def _flip_middle_word(secs):
    s = read_container(secs[1])
    words = bytearray(s.stream_words)
    words[(len(words) // 4) * 2] ^= 0x55
    s.stream_words = bytes(words)
    secs[1] = write_container(s)


def _swap(secs):
    secs[0], secs[1] = secs[1], secs[0]


def _fault(trip, name):
    _orig, data, pixels, _cfg = trip
    if name == "word_in_middle_section":
        bad = _rewrap(data, _flip_middle_word)
        return _point(trip, bad, _decode(bad))
    if name == "sections_swapped":
        bad = _rewrap(data, _swap)
        return _point(trip, bad, _decode(bad))
    if name == "epf_per_section":
        return _point(trip, pixels=torch.cat([_decode(s) for s in read_striped(data)[2]], dim=1))
    assert name == "stripe_off_by_one"
    w = pixels.shape[1] // 3
    off = pixels.clone()
    off[:, w : 2 * w] = torch.clamp(off[:, w : 2 * w].to(torch.int16) + 1, 0, 255).to(torch.uint8)
    return _point(trip, pixels=off)


def test_the_program_reads_zero(trip):
    _orig, data, _pixels, cfg = trip
    assert data[:4] == STRIPED_MAGIC and len(read_striped(data)[2]) == 3
    numbers = judge.judge([_point(trip)])
    assert numbers == {"encode_mismatch": 0.0, "decode_mismatch": 0.0}
    assert judge.verdict(numbers, cfg["correct_limits"])


@pytest.mark.parametrize("fault", ["word_in_middle_section", "sections_swapped", "epf_per_section",
                                   "stripe_off_by_one"])
def test_a_fault_of_the_striped_path_is_not_correct(trip, fault):
    cfg = trip[3]
    if fault == "epf_per_section":  # the fault shows only where the run's vote turns EPF on
        assert judge.epf_vote(read_container(s).header.epf for s in read_striped(trip[1])[2])
    numbers = judge.judge([_fault(trip, fault)])
    assert not judge.verdict(numbers, cfg["correct_limits"]), numbers


def test_a_run_is_a_centre_and_its_neighbours(trip):
    orig = trip[0]
    for n in (1, 2, 3, 13):
        a, b = judge.draw_run(orig, n)
        assert 0 <= a < b <= n
        assert b - a == min(n, judge.RUN) or (b - a == judge.RUN - 1 and (a == 0 or b == n))
    assert judge.draw_run(orig, 13) == judge.draw_run(orig.clone(), 13)


def test_the_control_fails_the_limits(trip):
    cfg = trip[3]
    numbers = judge.judge(judge.control_points([_point(trip)], "control"))
    assert not judge.verdict(numbers, cfg["correct_limits"]), numbers
    sound = judge.judge(judge.control_points([_point(trip)], "fp32_reordered"))
    assert judge.verdict(sound, cfg["correct_limits"]), sound
