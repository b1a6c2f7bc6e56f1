"""The port's distribution layer (jxl_tpu_torch/distributed, the sharded
striped encode, the mesh sweep) on the CPU, against the port's sequential
path and against jxl_tpu on the same numpy-seeded inputs.

Bars: sharded containers byte-identical to the port's sequential
`encode_image` / `encode_image_grid` under `modular=False`, and to
jxl_tpu's `encode_batch_sharded` wherever the per-image encodes of the two
packages give equal bytes (else within 0.5%); `sharded_epf` equal to the
port's `epf_apply` exactly and to the reference's within 1e-6; the mesh
sweep's CSV rows equal to the single-device sweep's.

Two CPU device names, `cpu` and `cpu:0`, stand for two distinct devices
where a test wants a mesh of more than one device."""

import csv
import os
import socket
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from jxl_tpu.codec.config import CodecConfig as JaxConfig
from jxl_tpu.distributed import mesh as jmesh
from jxl_tpu.distributed import sharded as jsh
from jxl_tpu.transforms.epf import epf_apply as jax_epf_apply

from jxl_tpu_torch.bench import sweep as tsw
from jxl_tpu_torch.codec.config import CodecConfig, Strategy
from jxl_tpu_torch.codec.decode import decode_bytes
from jxl_tpu_torch.codec.encode import encode_image, encode_image_grid
from jxl_tpu_torch.codec.tiled import encode_image_striped, encode_image_striped_sharded
from jxl_tpu_torch.core.io import write_image
from jxl_tpu_torch.cuda_build import launch_counts
from jxl_tpu_torch.distributed.mesh import Mesh, init_multihost, make_mesh
from jxl_tpu_torch.distributed.sharded import encode_batch_sharded, encode_grid_sharded, sharded_epf
from jxl_tpu_torch.transforms.epf import epf_apply

from tests.conftest import make_test_image
from tests.test_tiled import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO_DEVICES = [torch.device("cpu"), torch.device("cpu", 0)]


def test_mesh_shapes():
    m = make_mesh(["cpu"] * 8)
    assert isinstance(m, Mesh) and m.devices.shape == (8, 1)
    m2 = make_mesh(["cpu"] * 8, space=2)
    assert m2.devices.shape == (4, 2) and m2.axis_names == ("data", "space")
    assert (m2.shape["data"], m2.shape["space"]) == (4, 2)
    assert make_mesh(["cpu"] * 8, data=2).devices.shape == (2, 4)
    assert make_mesh(["cpu"] * 8, n_devices=4, data=2, space=2).devices.shape == (2, 2)
    assert all(isinstance(d, torch.device) for d in m2.devices.reshape(-1))
    # the reference's defaulting rule on its 8 virtual devices
    for kw in ({}, {"space": 2}, {"data": 2}):
        assert make_mesh(["cpu"] * 8, **kw).devices.shape == jmesh.make_mesh(8, **kw).devices.shape
    with pytest.raises(AssertionError):
        make_mesh(["cpu"] * 8, data=3)
    m3 = tsw.parse_mesh_spec("data=2, space=2", "cpu")
    assert m3.devices.shape == (2, 2) and set(m3.devices.reshape(-1)) == {torch.device("cpu")}
    with pytest.raises(ValueError):
        tsw.parse_mesh_spec("rows=2", "cpu")


def _batch():
    """The 6-image, 6-distance batch of tests/test_sharding.py."""
    h = w = 64
    rng = np.random.default_rng(0)
    base = rng.normal(0.5, 0.1, (6, h, w, 1))
    batch = np.clip(base + rng.normal(0, 0.05, (6, h, w, 3)), 0, 1)
    return (batch * 255).astype(np.uint8), [0.5, 1.0, 2.0, 1.0, 4.0, 1.5]


def test_sharded_encode_bit_exact_containers():
    batch, dists = _batch()
    cfg = CodecConfig(distance=1.0, effort=7)
    mesh = make_mesh(TWO_DEVICES * 4, space=2)  # data=4 rows over two distinct devices
    n0 = launch_counts()["rans_encode"]
    got = encode_batch_sharded(list(batch), cfg, distances=dists, mesh=mesh, orig_names=[f"i{i}" for i in range(6)])
    assert launch_counts()["rans_encode"] == n0  # CPU tensors: the plain version, no launch counted
    assert len(got) == 6
    for i in range(6):
        want = encode_image(batch[i], replace(cfg, distance=dists[i], modular=False), f"i{i}", device="cpu")
        assert got[i] == want, f"image {i} container differs"
        assert decode_bytes(got[i], device="cpu").shape == (64, 64, 3)
    # one [B, H, W, 3] array and a one-slot mesh give the same containers
    again = encode_batch_sharded(batch, cfg, distances=dists, mesh=make_mesh(["cpu"]), orig_names=[f"i{i}" for i in range(6)])
    assert again == got

    ref = jsh.encode_batch_sharded(
        list(batch), JaxConfig(distance=1.0, effort=7), distances=dists, mesh=jmesh.make_mesh(8, space=2),
        orig_names=[f"i{i}" for i in range(6)],
    )
    same = sum(g == r for g, r in zip(got, ref))
    for g, r in zip(got, ref):
        assert abs(len(g) - len(r)) <= 0.005 * len(r)
    assert same >= 4, same


def test_sharded_encode_checks():
    batch, _d = _batch()
    cfg = CodecConfig(distance=1.0, effort=3)
    with pytest.raises(ValueError, match="explicit mesh"):
        encode_batch_sharded(list(batch[:2]), cfg)
    with pytest.raises(AssertionError, match="space axis"):
        encode_batch_sharded(list(batch[:2]), cfg, mesh=make_mesh(["cpu"] * 3, data=1, space=3))
    with pytest.raises(ValueError, match="one geometry"):
        encode_batch_sharded([batch[0], batch[1][:, :32]], cfg, mesh=make_mesh(["cpu"]))
    # distances are floored at 0.05 and the path always codes VarDCT
    flat = np.zeros((32, 48, 3), np.uint8)
    flat[8:24, 8:40] = (200, 40, 90)
    (blob,) = encode_batch_sharded([flat], cfg, distances=[0.0], mesh=make_mesh(["cpu"]))
    assert blob == encode_image(flat, replace(cfg, distance=0.05, modular=False), device="cpu")


def test_grid_sharded_equals_encode_image_grid():
    imgs = [make_test_image(32, 40, seed=s) for s in (0, 1, 2)]
    dists = (0.0, 1.0, 3.0)
    cfg = CodecConfig(effort=7, strategy=Strategy.HOMOGENEITY_PARTITIONING)
    got = encode_grid_sharded(imgs, cfg, dists, mesh=make_mesh(TWO_DEVICES, data=2), orig_names=["a", "b", "c"])
    assert [len(row) for row in got] == [3, 3, 3]
    for img, name, row in zip(imgs, "abc", got):
        assert row == encode_image_grid(img, replace(cfg, modular=False), dists, name, device="cpu")


def test_sharded_epf_matches_unsharded():
    rng = np.random.default_rng(7)
    h, w = 32, 8 * 8 * 4
    planes = rng.normal(0.4, 0.1, (3, h, w)).astype(np.float32)
    eff = rng.uniform(0.6, 2.0, (h // 8, w // 8)).astype(np.float32)
    pt, et = torch.from_numpy(planes), torch.from_numpy(eff)
    want = epf_apply(pt, et, 2.0)
    for space in (1, 2, 4):
        got = sharded_epf(pt, et, 2.0, make_mesh(TWO_DEVICES * 4, space=space))
        assert torch.equal(got, want), space
    np.testing.assert_allclose(want.numpy(), np.asarray(jax_epf_apply(planes, eff, 2.0)), atol=1e-6)
    with pytest.raises(AssertionError, match="whole block columns"):
        sharded_epf(pt[:, :, : 8 * 6], et[:, :6], 2.0, make_mesh(["cpu"] * 4, space=4))


def test_striped_sharded_matches_sequential():
    img = synth(64, 4 * 64, seed=9)
    cfg = CodecConfig(distance=1.0, effort=6)
    mesh = make_mesh(TWO_DEVICES * 2, data=4, space=1)
    seq = encode_image_striped(img, cfg, n_stripes=4, orig_name="s.png", device="cpu")
    assert encode_image_striped_sharded(img, cfg, mesh, n_stripes=4, orig_name="s.png") == seq
    assert encode_image_striped_sharded(img, cfg, mesh, orig_name="s.png") == seq  # default: the data size
    with pytest.raises(AssertionError, match="sequential-only"):
        encode_image_striped_sharded(img, replace(cfg, distance=0.0), mesh)
    with pytest.raises(AssertionError, match="equal block-aligned"):
        encode_image_striped_sharded(img[:, :200], cfg, mesh)


def test_init_multihost_single_process_noop():
    """init_multihost is safe to call unconditionally in one process; with
    several processes announced and no coordinator it raises."""
    import torch.distributed as dist

    init_multihost()
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        init_multihost(num_processes=2, process_id=0)
    (blob,) = encode_batch_sharded([make_test_image(32, 40, seed=3)], CodecConfig(effort=3), mesh=make_mesh(["cpu"]))
    assert blob == encode_image(make_test_image(32, 40, seed=3), CodecConfig(effort=3, modular=False), device="cpu")


def test_two_process_distributed_encode():
    """Two OS processes form a gloo group on 127.0.0.1, each encodes its
    share, and both end with every container, byte-identical to the
    single-device encode (tools/multihost_worker_torch.py)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    worker = os.path.join(REPO, "tools", "multihost_worker_torch.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, "2", str(pid), "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid={pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK pid={pid} imgs=2" in out, out[-3000:]


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_imgs")
    (root / "mini").mkdir()
    for i in range(3):
        write_image(str(root / "mini" / f"im{i}.png"), make_test_image(32, 40, seed=i))
    write_image(str(root / "mini" / "wide.png"), make_test_image(32, 48, seed=7))  # a second geometry
    return str(root)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_mesh_sweep_rows_equal_single_device(tiny_set, tmp_path):
    kw = dict(test_image_dir=tiny_set, distances=(0.0, 1.0, 3.0), efforts=(7,), device="cpu")
    single = tsw.SweepRunner(tsw.SweepConfig(benchmark_dir=str(tmp_path / "a"), **kw))
    rows_s = single.run_test_set("mini", Strategy.BASELINE)
    meshed = tsw.SweepRunner(tsw.SweepConfig(benchmark_dir=str(tmp_path / "b"), mesh="data=2,space=2", **kw))
    rows_m = meshed.run_test_set("mini", Strategy.BASELINE)
    assert len(rows_s) == len(rows_m) == 12
    for name in ("results.csv", "comparisons.csv"):
        a = _rows(os.path.join(single.out_dirs("mini", Strategy.BASELINE)["results"], name))
        b = _rows(os.path.join(meshed.out_dirs("mini", Strategy.BASELINE)["results"], name))
        assert sorted(a[1:]) == sorted(b[1:]) and a[0] == b[0], name  # mesh mode walks by geometry: same rows
    t = _rows(meshed.timings_csv("mini", Strategy.BASELINE))
    assert t[0] == tsw.TIMINGS_HEADER and len(t) == 13
    out_s, out_m = (r.out_dirs("mini", Strategy.BASELINE)["output"] for r in (single, meshed))
    for f in sorted(os.listdir(out_s)):
        with open(os.path.join(out_s, f), "rb") as fa, open(os.path.join(out_m, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    # resume: nothing is left to do, no row is written twice
    again = tsw.SweepRunner(meshed.config, run_dir=meshed.run_dir)
    assert again.run_test_set("mini", Strategy.BASELINE) == []
    assert len(_rows(meshed.comparisons_csv("mini", Strategy.BASELINE))) == 13
