"""The port's headline benchmark (jxl_tpu_torch/bench/headline.py, run by
bench_torch.py) on the CPU, against bench.py and jxl_tpu.

- the bench image is bench.py's, array for array;
- at 64x96 (B = 2, 2 rows a trial, 1 trial) the result is one JSON object
  holding every key bench.py prints (its json.dumps dict, read with ast),
  plus device, launches and trace; off the card the device-time keys are
  null, and the roofline's bytes are the floor from the stream's shapes;
- its bpp and PSNR are within the encoder's bars (bytes 0.5%, PSNR 0.02 dB,
  tests/test_torch_encode.py) of jxl_tpu's encode of the same image;
- the op counter counts 2mnk FLOPs and 4(mk + kn + mn) bytes for a float32
  product, 0 for a view; the floor bytes do not depend on the op split;
  the trace's interval union and kernel filter;
- without PIL the libjpeg anchor's keys are null; a CUDA device without a
  card raises, and bench_torch.py exits non-zero.
"""

import ast
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench
from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.codec.decode import decode_bytes as jax_decode
from jxl_tpu.codec.encode import encode_image as jax_encode

from jxl_tpu_torch.bench import headline as hl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
SMALL = dict(batch=2, reps=1, iters=2)
ANCHOR_KEYS = ("vs_baseline", "jpeg_cpu_mps_measured", "vs_jpeg_cpu", "jpeg_cpu_mps_spread")


def psnr(a, b) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(10 * np.log10(255.0**2 / np.mean(d * d)))


def bench_keys():
    """(top-level keys, roofline keys) of the dict bench.py prints."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    (printed,) = [
        n.args[0] for n in ast.walk(tree)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps"
    ]
    top = {k.value: v for k, v in zip(printed.keys, printed.values)}
    return set(top), {k.value for k in top["roofline"].keys}


@pytest.fixture(scope="module")
def result():
    return json.loads(json.dumps(hl.headline(hl.synth_kodak(H, W), device="cpu", **SMALL)))


@pytest.mark.parametrize("h,w,seed", [(64, 96, 0), (512, 768, 0), (100, 130, 7)])
def test_synth_kodak_is_bench_image(h, w, seed):
    np.testing.assert_array_equal(hl.synth_kodak(h, w, seed), bench.synth_kodak(h, w, seed))


def test_json_holds_every_bench_key(result):
    top, roof = bench_keys()
    assert len(top) == 18 and len(roof) == 16
    assert top <= set(result) and roof <= set(result["roofline"])
    assert set(result) - top <= {"device", "launches", "trace", "baseline_note"}
    assert result["device"] == {"name": "cpu", "power_limit_w": None}
    assert result["metric"] == "encode+decode MP/s on cpu (VarDCT d=1)"
    # off the card the wrappers run their plain versions: no launch, no trace
    assert result["launches"] == {"rans_encode": 0, "rans_decode": 0, "rans_decode_batched": 0, "screen": 0, "dct2d": 0,
                                   "hist": 0}
    assert result["trace"] is None
    assert result["grid_batch"] == 2 and result["reps"] == 1
    assert all(v > 0 for v in (result["value"], result["encode_mps"], result["decode_mps"]))
    roof = result["roofline"]
    assert roof["encode_gflops"] > 0 and roof["encode_eager_mb"] > roof["encode_hbm_mb"] > 0
    assert roof["decode_eager_mb"] > roof["decode_hbm_mb"] > 0
    for stage in ("encode", "decode"):
        assert all(roof[f"{stage}_{k}"] is None for k in ("device_ms", "device_frac", "dispatch_fixed_ms"))
        light = max(roof[f"{stage}_gflops"] * 1e9 / hl.PEAK_FLOPS, roof[f"{stage}_hbm_mb"] * 1e6 / hl.PEAK_BW) * 1e3
        assert roof[f"{stage}_lightspeed_ms"] == pytest.approx(light, rel=1e-2, abs=1e-4)


def test_floor_bytes_from_the_stream(result):
    """The roofline's bytes are the floor functions of the image's and the
    stream's shapes, the same whatever ops ran."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.encode import encode_image
    from jxl_tpu_torch.codec.layout import padded_layout
    from jxl_tpu_torch.entropy import kernel_bounds as kb

    data = encode_image(hl.synth_kodak(H, W), CodecConfig(distance=1.0, effort=7), device="cpu")
    st = read_container(data)
    lanes = st.header.lanes
    T = padded_layout(H, W, lanes)["T"]
    nw, nm = int(st.wcounts.sum()), int(st.mcounts.sum())
    enc = hl.encode_floor_bytes(H, W, T, lanes, nw, nm, len(data))
    dec = hl.decode_floor_bytes(H, W, T, lanes, nw, nm, len(data))
    assert enc == H * W * 3 + 8 * T * lanes + kb.encode_bytes(T, lanes, nw, nm) + len(data)
    assert dec == len(data) + kb.decode_bytes(T, lanes, nw, nm) + 4 * T * lanes + H * W * 3
    assert (result["roofline"]["encode_hbm_mb"], result["roofline"]["decode_hbm_mb"]) == (
        round(enc / 1e6, 3), round(dec / 1e6, 3),
    )


def test_quality_within_bars_of_reference(result):
    img = hl.synth_kodak(H, W)
    jax_data = jax_encode(img, JaxConfig(distance=1.0, effort=7))
    q_jax = psnr(img, np.asarray(jax_decode(jax_data)))
    port_bytes = result["bpp"] * H * W / 8
    print(f"bpp {result['bpp']} ({port_bytes:.1f} B) vs {len(jax_data)} B; PSNR {result['psnr_db']} vs {q_jax:.4f} dB")
    assert abs(port_bytes / len(jax_data) - 1.0) <= 0.005
    assert abs(result["psnr_db"] - q_jax) <= 0.02


def test_op_counter_on_a_product():
    m, k, n = 5, 7, 3
    a, b = torch.randn(m, k), torch.randn(k, n)
    with hl.count_ops("cpu") as c:
        torch.mm(a, b)
    assert (c.flops, c.bytes) == (2 * m * n * k, 4 * (m * k + k * n + m * n))
    with hl.count_ops("cpu") as v:
        a.view(k, m)
        a.t()
    assert (v.flops, v.bytes) == (0, 0)


def test_busy_ms_is_the_union_of_intervals():
    assert hl.busy_ms([]) == 0.0
    # disjoint, nested, overlapping and touching spans, in any order (ns)
    spans = [(5_000_000, 6_000_000), (0, 2_000_000), (500_000, 1_000_000), (1_500_000, 3_000_000), (3_000_000, 4_000_000)]
    assert hl.busy_ms(spans) == 5.0


def test_kernel_intervals_keep_cuda_kernels_only():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(dev, name, s, e):
        return SimpleNamespace(device_type=lambda: dev, name=lambda: name, start_ns=lambda: s, end_ns=lambda: e)

    events = [
        ev(cuda, "rans_encode_kernel", 0, 10), ev(cuda, "Memcpy DtoH (Device -> Pageable)", 5, 20),
        ev(cuda, "Memset (Device)", 12, 14), ev(cpu, "aten::mm", 0, 30), ev(cuda, "void gemmSN_NN_kernel", 40, 50),
    ]
    assert hl.kernel_intervals(events) == [(0, 10), (40, 50)]


def test_anchor_keys_null_without_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = hl.synth_kodak(H, W)
    assert hl.jpeg_trials(img, 2) is None
    r = hl.headline(img, device="cpu", batch=2, reps=1, iters=1)
    assert all(r[k] is None for k in ANCHOR_KEYS)
    assert "PIL" in r["baseline_note"]
    assert r["value"] > 0


def test_anchor_measured_with_pil(result):
    pytest.importorskip("PIL")
    assert all(result[k] is not None for k in ANCHOR_KEYS) and "baseline_note" not in result
    lo, hi = result["jpeg_cpu_mps_spread"]
    assert 0 < lo <= result["jpeg_cpu_mps_measured"] <= hi
    assert result["vs_baseline"] == result["vs_jpeg_cpu"]


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hl.headline(hl.synth_kodak(H, W), device="cuda:0", **SMALL)


def test_bench_torch_exits_nonzero_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench_torch.py"], cwd=REPO, env={**env, "JXL_BENCH_SIZE": "64x96"},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr and out.stdout == ""
