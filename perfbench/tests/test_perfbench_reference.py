"""The frozen reference against the program's CPU path at a small size."""

import numpy as np
import pytest
import torch

from perfbench.reference import codec as rc
from perfbench.reference.judges import vardct as J
from perfbench.reference.battery import metric_battery_grid_async as ref_battery
from perfbench.reference.container import read_container
from perfbench.reference.values import decode_values_np
from perfbench.sources.synth_photo import synth_photo

from jxl_tpu_torch.codec.config import CodecConfig, Strategy
from jxl_tpu_torch.codec.container import read_container as prog_read
from jxl_tpu_torch.codec.decode import decode_bytes_grid_stacked, decode_values
from jxl_tpu_torch.codec.encode import encode_image_grid
from jxl_tpu_torch.metrics.battery import metric_battery_grid_async

H, W = 64, 96
DISTANCES = [0.5, 1.0, 6.0, 14.0]


@pytest.fixture(scope="module", params=[5, 7, 9])
def row(request):
    e = request.param
    img = synth_photo(H, W, 1000 + e, "cpu")
    datas = encode_image_grid(img.numpy(), CodecConfig(effort=e), DISTANCES, device="cpu")
    pix = decode_bytes_grid_stacked(datas, device="cpu")
    return e, img, datas, pix


def test_value_streams_equal_the_programs(row):
    _e, _img, datas, _pix = row
    ref = decode_values_np([read_container(d) for d in datas])
    for v, d in zip(ref, datas):
        assert np.array_equal(v, decode_values(prog_read(d), "cpu").numpy())


def test_front_end_equals_the_encoders(row):
    e, img, datas, _pix = row
    for d, data in zip(DISTANCES, datas):
        _t, _n, _m, params, _q, values = rc.tokens_from_rgb(img, J.floored(d), height=H, width=W, effort=e)
        s = read_container(data)
        assert np.array_equal(values.numpy(), decode_values_np([s])[0])
        assert J.decode_params(params) == s.header.decode_params


def test_reconstruction_and_battery_equal_the_programs(row):
    _e, img, datas, pix = row
    prog = metric_battery_grid_async(img, pix)()
    for i, (d, data) in enumerate(zip(DISTANCES, datas)):
        s = read_container(data)
        rec = J.reconstruct(decode_values_np([s])[0], s.header.decode_params, d, H, W, "cpu")
        assert torch.equal(rec, pix[i])
        ref = ref_battery(img, pix[i : i + 1])()[0]
        assert J.battery_gap(prog[i], ref) < 1.0


def test_the_program_reads_zero(row):
    e, img, datas, pix = row
    bat = metric_battery_grid_async(img, pix)()
    pts = [J.Point(img, d, e, pix[i], container=datas[i], battery=bat[i]) for i, d in enumerate(DISTANCES)]
    numbers = J.judge(pts)
    assert numbers["encode_mismatch"] == 0 and numbers["decode_mismatch"] == 0
    assert numbers["battery_gap"] < 1.0


def test_a_container_of_another_request_reads_one(row):
    e, img, datas, pix = row
    pts = [J.Point(img, DISTANCES[0], e, pix[0], container=datas[1]),
           J.Point(img, DISTANCES[1], e + 1, pix[1], container=datas[1]),
           J.Point(img, DISTANCES[1], e, pix[1], container=b"JXT1" + datas[1][4:20])]
    for p in pts:
        assert J.judge([p])["encode_mismatch"] == 1.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 3.14159265], dtype=torch.float32)
    y = rc_tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2**-10
    assert y[1] in (1.0, 1.0 + 2**-10)
    assert (y.view(torch.int32) & 0x1FFF == 0).all()


def rc_tf32(x):
    from perfbench.reference.dct import to_tf32

    return to_tf32(x)


@pytest.mark.parametrize("strategy", [s.name for s in Strategy if s is not Strategy.BASELINE])
def test_every_strategy_is_judged_against_its_own_front_end(strategy):
    """A row under each of the thesis's homogeneity variants reads 0, and
    the same containers judged as another strategy read 1."""
    img = synth_photo(H, W, 2000 + len(strategy), "cpu")
    datas = encode_image_grid(img.numpy(), CodecConfig(effort=7, strategy=Strategy[strategy]), DISTANCES,
                              device="cpu")
    pix = decode_bytes_grid_stacked(datas, device="cpu")
    pts = [J.Point(img, d, 7, pix[i], strategy, container=datas[i]) for i, d in enumerate(DISTANCES)]
    assert J.judge(pts) == {"encode_mismatch": 0.0, "decode_mismatch": 0.0}
    other = "BASELINE" if strategy != "BASELINE" else "COMBINED"
    assert J.judge([J.Point(img, DISTANCES[0], 7, pix[0], other, container=datas[0])])["encode_mismatch"] == 1.0
