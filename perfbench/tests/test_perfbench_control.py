"""The control, the reference at TF32 in the program's place, comes out as
not correct under each configuration's limits (at a test-sized image; the
readings at the cells' own sizes are in PERF.md)."""

import json
from pathlib import Path

import pytest

from perfbench.reference.judges import vardct as J
from perfbench.sources.synth_photo import synth_photo

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("config", sorted(p.stem for p in CONFIGS.glob("*.json")))
def test_the_control_fails_the_limits(config):
    limits = json.loads((CONFIGS / f"{config}.json").read_text())["correct_limits"]
    pts = []
    for k, (d, e) in enumerate([(0.5, 5), (1.0, 7), (3.0, 9)]):
        img = synth_photo(64, 96, 500 + k, "cpu")
        pts.append(J.Point(img, d, e, img, battery={} if "battery_gap" in limits else None))
    # the control needs only the originals and the settings; its own
    # pixels and battery rows replace these
    control = J.control_points(pts)
    numbers = J.judge(control)
    assert set(numbers) == set(limits)
    assert not J.verdict(numbers, limits), numbers


def test_the_reference_in_full_precision_passes():
    img = synth_photo(64, 96, 501, "cpu")
    pts = [J.Point(img, 1.0, 7, img, battery={})]
    ref = J.control_points(pts)
    # the same reference, judged against itself in float32, reads 0
    for p in ref:
        p.values, p.params = J.reference_values(p)
        p.pixels = J.reconstruct(p.values, J.decode_params(p.params), p.distance, 64, 96, "cpu")
        from perfbench.reference.battery import metric_battery_grid_async

        p.battery = metric_battery_grid_async(p.orig, p.pixels[None])()[0]
    numbers = J.judge(ref)
    assert numbers == {"encode_mismatch": 0.0, "decode_mismatch": 0.0, "battery_gap": 0.0}
