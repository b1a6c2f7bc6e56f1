#!/usr/bin/env python3
"""The mesh paths of jxl_tpu_torch/distributed over DISTINCT devices,
beside chip_smoke.py (whose phase 8 runs them on slots of one card):

    python3 probes/mesh_devices.py [--devices cuda:0 cuda:1 ...] [--size HxW]

Run from the repository root. With no --devices it takes every CUDA card
of the machine and needs at least two. Each check raises on a miss:

- encode_batch_sharded of 2 images per device on a data=N mesh, against
  encode_image on the first device (byte-identical), both timed (one warm
  run each). The sharded path runs the images in order, one device after
  another; beside it the probe times a variant of its own with one host
  thread per device (each on its card's default stream), the design the
  port does not use: this is the measurement that says why;
- encode_image_striped_sharded of one image in N stripes against
  encode_image_striped on the first device;
- sharded_epf with one column shard per device (space=N) against
  epf_apply on the first device (equal exactly);
- the launch counter of the encode kernel against the number of encodes
  (not under the probe's threads, whose increments may race);
- with --switch-intervals S [S ...]: the sharded batch encode timed again
  under the probe's threads at each interpreter switch interval (`sys.setswitchinterval`, seconds;
  the default is 0.005), then restored: how much of the threads' wall is
  waiting for the interpreter lock after each device synchronisation;
- with --processes: the same batch once more as one PROCESS per device
  (a `torch.distributed` gloo group on localhost formed by
  `init_multihost`, each rank with a one-slot mesh of its own device):
  every rank must hold every container, byte-identical; the slowest
  rank's warm wall is printed beside the threads'.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def photo(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    lum = 0.55 + 0.25 * np.sin(xx / 41.0) * np.cos(yy / 29.0) + rng.normal(0, 0.025, (h, w)).astype(np.float32)
    lum = np.clip(lum + 0.15 * (((xx // 96).astype(np.int32) ^ (yy // 64).astype(np.int32)) % 2), 0, 1)
    rgb = np.stack([lum * (0.85 + 0.15 * np.sin(yy / 83.0)), lum, lum * (0.75 + 0.25 * np.cos(xx / 71.0))], axis=-1)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="*", default=None)
    ap.add_argument("--size", default="512x768")
    ap.add_argument("--switch-intervals", type=float, nargs="*", default=[])
    ap.add_argument("--processes", action="store_true")
    ap.add_argument("--rank", type=int, default=None, help="(internal) run as this rank of --coordinator's group")
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args()
    devices = args.devices or [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if len(set(devices)) < 2:
        print("mesh_devices: needs at least two distinct devices", file=sys.stderr)
        return 2
    h, w = (int(v) for v in args.size.split("x"))
    n = len(devices)

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_stream_planes
    from jxl_tpu_torch.codec.encode import encode_image
    from jxl_tpu_torch.codec.tiled import encode_image_striped, encode_image_striped_sharded
    from jxl_tpu_torch.core.device import resolve_device
    from jxl_tpu_torch.distributed.mesh import make_mesh
    from jxl_tpu_torch.distributed.sharded import encode_batch_sharded, sharded_epf
    from jxl_tpu_torch.entropy.cuda_rans_enc import encode_grouped_cuda
    from jxl_tpu_torch.transforms.epf import epf_apply

    devs = [resolve_device(d) for d in devices]
    cuda = devs[0].type == "cuda"
    names = [torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu" for d in devs]
    print(f"[mesh_devices] {n} devices: " + ", ".join(f"{d} ({nm})" for d, nm in zip(devs, names)))

    def sync():
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    imgs = [photo(h, w, seed=s) for s in range(2 * n)]
    dists = [0.5 + 0.5 * (i % 4) for i in range(2 * n)]
    cfg = CodecConfig(distance=1.0, effort=7)
    mesh = make_mesh(devs, data=n)

    def sharded():
        return encode_batch_sharded(imgs, cfg, distances=dists, mesh=mesh)

    def sequential():
        return [encode_image(im, replace(cfg, distance=d, modular=False), device=devs[0]) for im, d in zip(imgs, dists)]

    def threaded():
        def on_device(k):
            return [(i, encode_image(imgs[i], replace(cfg, distance=dists[i], modular=False), device=devs[k])) for i in range(k, len(imgs), n)]

        with ThreadPoolExecutor(max_workers=n) as ex:
            done = dict(kv for part in ex.map(on_device, range(n)) for kv in part)
        return [done[i] for i in range(len(imgs))]

    if args.rank is not None:  # one rank of the --processes run
        import torch.distributed as dist

        from jxl_tpu_torch.distributed.mesh import init_multihost

        init_multihost(args.coordinator, num_processes=n, process_id=args.rank)
        own = make_mesh([devs[args.rank]])
        want = [encode_image(im, replace(cfg, distance=d, modular=False), device=devs[args.rank]) for im, d in zip(imgs, dists)]
        encode_batch_sharded(imgs, cfg, distances=dists, mesh=own)  # warm
        dist.barrier()
        t0 = time.perf_counter()
        out = encode_batch_sharded(imgs, cfg, distances=dists, mesh=own)
        wall = time.perf_counter() - t0
        if out != want:
            raise AssertionError(f"rank {args.rank}: containers differ from encode_image")
        dist.barrier()
        dist.destroy_process_group()
        print(f"RANK_OK {args.rank} {wall:.3f}", flush=True)
        return 0

    got, want = sharded(), sequential()  # first use: builds and loads the kernels, warms every device
    if got != want:
        raise AssertionError("encode_batch_sharded differs from encode_image")
    walls = {}
    for tag, fn in (("sharded", sharded), ("sequential", sequential), ("sharded again", sharded), ("threads", threaded), ("threads again", threaded)):
        n0 = encode_grouped_cuda.launches
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[tag] = time.perf_counter() - t0
        if out != want:
            raise AssertionError(f"{tag}: containers differ")
        if cuda and fn is not threaded and encode_grouped_cuda.launches - n0 != len(imgs):
            raise AssertionError(f"{tag}: {encode_grouped_cuda.launches - n0} encode launches counted for {len(imgs)} encodes")
    print(
        f"[mesh_devices] encode_batch_sharded, {len(imgs)} images of {h}x{w} on data={n}: byte-identical to "
        "encode_image on the first device; wall " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + "; one encode launch counted per image"
    )

    default_interval = sys.getswitchinterval()
    for interval in args.switch_intervals:
        sys.setswitchinterval(interval)
        try:
            ts = []
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                out = threaded()
                sync()
                ts.append(time.perf_counter() - t0)
        finally:
            sys.setswitchinterval(default_interval)
        if out != want:
            raise AssertionError(f"switch interval {interval}: containers differ")
        print(f"[mesh_devices] switch interval {interval:g} s (default {default_interval:g}): threads' wall " + ", ".join(f"{t:.3f} s" for t in ts))

    if args.processes:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            coordinator = f"127.0.0.1:{sk.getsockname()[1]}"
        cmd = [sys.executable, __file__, "--devices", *devices, "--size", args.size, "--coordinator", coordinator]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        rank_walls = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            ok = [ln for ln in out.splitlines() if ln.startswith(f"RANK_OK {r} ")]
            if p.returncode != 0 or not ok:
                raise AssertionError(f"rank {r} failed:\n{out[-2000:]}")
            rank_walls.append(float(ok[0].split()[2]))
        print(
            f"[mesh_devices] one process per device ({n} ranks, gloo): every rank holds all {len(imgs)} containers, "
            f"byte-identical; warm wall per rank " + ", ".join(f"{t:.3f} s" for t in rank_walls)
            + f" (threads {walls['threads again']:.3f} s, in-order over the devices {walls['sharded again']:.3f} s, sequential on one device {walls['sequential']:.3f} s)"
        )

    wide = photo(h, 32 * n * max(1, w // (32 * n)), seed=99)
    scfg = CodecConfig(distance=3.0, effort=7)
    striped = encode_image_striped(wide, scfg, n, "wide", device=devs[0])
    if encode_image_striped_sharded(wide, scfg, mesh, orig_name="wide") != striped:
        raise AssertionError("encode_image_striped_sharded differs from encode_image_striped")
    planes, eff_mul = decode_stream_planes(read_container(encode_image(wide, scfg, device=devs[0])), device=devs[0])
    if not torch.equal(sharded_epf(planes, eff_mul, 3.0, make_mesh(devs, space=n)), epf_apply(planes, eff_mul, 3.0)):
        raise AssertionError("sharded_epf differs from epf_apply")
    print(
        f"[mesh_devices] encode_image_striped_sharded ({n} stripes of {tuple(wide.shape[:2])}) equals "
        f"encode_image_striped; sharded_epf on space={n} equals epf_apply exactly on {tuple(planes.shape)}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
