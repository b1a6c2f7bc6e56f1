"""Rate-distortion sweep runner (port of `jxl_tpu/bench/sweep.py`).

For each image of each test set, sweep the distance x effort grid, record
a 13-column metadata row per file and a 17-column ComparisonResult row per
grid point, with the reference's run numbering (`benchmarks/<n>/`, n =
max + 1), `.done.jsonl` resume markers, `timings.csv` and the legacy
`--decompress` / `--compare-images` stages. Every point is encoded,
decoded and scored on `SweepConfig.device`:

- a row's lossy distances encode through `encode_image_grid` (d = 0
  through `encode_image`), one rANS encode kernel launch per coded stream;
- a uniform row decodes through `decode_bytes_grid_stacked` (one batched
  decode launch per phase); a mixed row (modular and VarDCT points, a
  palette stream) returns None there and decodes stream by stream;
- the metric battery scores the decoded `[N, H, W, 3]` stack against the
  original in one pass and fetches `[N, 6]` once.

Decode and metric wall times end in `torch.cuda.synchronize()` on a CUDA
device. In mesh mode (`SweepConfig.mesh`, `bench --mesh data=N[,space=M]`)
batches of N same-geometry images encode through
`distributed.sharded.encode_grid_sharded` over a mesh of `device` slots;
the containers are the single-device path's with `modular=False`, and
decode, battery and CSVs are shared.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from jxl_tpu_torch.bench.csv_schema import (
    COMPARISON_RESULT_HEADER,
    IMAGE_FILE_DATA_HEADER,
    ComparisonResult,
    append_rows,
    write_csv_header,
)
from jxl_tpu_torch.codec.config import CodecConfig, Strategy
from jxl_tpu_torch.codec.container import read_container
from jxl_tpu_torch.codec.decode import decode_bytes_grid_stacked, decode_stream_device
from jxl_tpu_torch.codec.encode import encode_image, encode_image_grid
from jxl_tpu_torch.core.device import resolve_device
from jxl_tpu_torch.core.io import read_image, read_image_metadata, write_image
from jxl_tpu_torch.metrics import file_size_ratio
from jxl_tpu_torch.metrics.battery import metric_battery_async, metric_battery_grid_async

# Reference sweep grids:
# Rust harness (`benchmark.rs:637-638`)
RUST_DISTANCES = (0.5, 1.0, 1.5, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0)
RUST_EFFORTS = (5, 6, 7, 8, 9)
# Legacy python pipeline (`old_test_jxl.py:16-27`) — includes d=0.0 and e=1..9
LEGACY_DISTANCES = (0.0, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 15.0, 25.0)
LEGACY_EFFORTS = tuple(range(1, 10))

# Decompression-stage table (column parity with the legacy pipeline's
# ImageDecompressionData.get_col_names(), old_test_jxl.py:133-158).
DECOMPRESSION_HEADER = [
    "Original Image Path",
    "Compressed Image Path",
    "Decompressed Image Path",
    "Compression Effort",
    "Compression Distance",
    "Image Dims",
    "Original Image Size",
    "Original Image Format",
    "Compressed Image Size",
    "Compressed Image Format",
    "Decompressed Image Size",
    "Decompressed Image Format",
    "Delta Original Image Size",
    "% of Original Image Size",
    "Delta Compressed Image Size",
    "% of Compressed Image Size",
]

# Per-grid-point timing rows (written to timings.csv, NOT the reference
# 17-col schema: that file stays byte-compatible).
TIMINGS_HEADER = [
    "Image Name",
    "Distance",
    "Effort",
    "Encode Time (s)",
    "Decode Time (s)",
    "Metrics Time (s)",
    "Encode MP/s",
    "Decode MP/s",
    # 1 when this (geometry, effort, strategy, grid-shape) signature was
    # already run in this process, 0 when the row carries first-use costs
    # (the kernels' nvcc build, cuBLAS handles, allocator growth):
    # averages must filter Warm == 1.
    "Warm",
]

_IMAGE_EXTS = (".png", ".ppm", ".pnm", ".bmp", ".jpg", ".jpeg")


@dataclass
class SweepConfig:
    benchmark_dir: str = "./benchmarks"
    test_image_dir: str = "./test_images"
    distances: Sequence[float] = RUST_DISTANCES
    efforts: Sequence[int] = RUST_EFFORTS
    strategy: Strategy = Strategy.BASELINE
    keep_artifacts: bool = True  # write .jxt/.png outputs like the reference
    # legacy-pipeline stages: write decoded PNGs + decompressed-size table /
    # amplified |orig - decoded| diff images
    decompress: bool = False
    compare_images: bool = False
    # "data=N" or "data=N,space=M": encode batches of N images per mesh
    # call over slots of `device` instead of one image row at a time.
    # None = single-device.
    mesh: Optional[str] = None
    # where every point is encoded, decoded and scored: no default
    device: Optional[str] = None

    def __post_init__(self):
        if self.device is None:
            raise ValueError("SweepConfig needs an explicit device (e.g. 'cuda:0' or 'cpu')")
        if self.mesh:
            parse_mesh_spec(self.mesh, self.device)  # a malformed spec fails before any work


def parse_mesh_spec(spec: str, device):
    """"data=4,space=2" -> a distributed.mesh.Mesh of data x space slots of
    `device` (data and space default to 1)."""
    from jxl_tpu_torch.distributed.mesh import make_mesh

    kv = dict(part.split("=") for part in spec.replace(" ", "").split(","))
    if not set(kv) <= {"data", "space"}:
        raise ValueError(f"mesh spec {spec!r}: expected data=N[,space=M]")
    data, space = int(kv.get("data", 1)), int(kv.get("space", 1))
    if data < 1 or space < 1:
        raise ValueError(f"mesh spec {spec!r}: sizes must be >= 1")
    return make_mesh([device] * (data * space), data=data, space=space)


def discover_test_sets(test_image_dir: str) -> list[str]:
    """Subdirectories of test_images/ (reference: `benchmark.rs:312-331`)."""
    if not os.path.isdir(test_image_dir):
        return []
    return sorted(d for d in os.listdir(test_image_dir) if os.path.isdir(os.path.join(test_image_dir, d)))


def next_run_number(benchmark_dir: str) -> int:
    """max(numeric dir) + 1 (reference: `benchmark.rs:280-302`)."""
    if not os.path.isdir(benchmark_dir):
        return 0
    nums = [int(d) for d in os.listdir(benchmark_dir) if d.isdigit()]
    return (max(nums) + 1) if nums else 0


def _sync(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class SweepRunner:
    """Runs the grid for one strategy ("commit" analog) over test sets."""

    def __init__(self, config: SweepConfig, run_dir: Optional[str] = None):
        self.config = config
        self.device = resolve_device(config.device)
        if run_dir is None:
            n = next_run_number(config.benchmark_dir)
            run_dir = os.path.join(config.benchmark_dir, str(n))
        self.run_dir = run_dir
        os.makedirs(self.run_dir, exist_ok=True)
        # signatures already run in this process, for timings.csv's Warm column
        self._warm_sigs: set = set()

    # --- resumability ------------------------------------------------------
    def _marker_path(self, test_set: str, strategy: Strategy) -> str:
        return os.path.join(self.run_dir, test_set, strategy.name, ".done.jsonl")

    def _load_done(self, test_set: str, strategy: Strategy) -> set:
        path = self._marker_path(test_set, strategy)
        done = set()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if line.strip():
                        rec = json.loads(line)
                        done.add((rec["image"], rec["d"], rec["e"]))
        return done

    def _mark_done(self, test_set: str, strategy: Strategy, image: str, d: float, e: int):
        path = self._marker_path(test_set, strategy)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps({"image": image, "d": d, "e": e}) + "\n")

    # --- paths (the reference's output dirs, benchmark.rs:107-137) ---------
    def out_dirs(self, test_set: str, strategy: Strategy) -> dict:
        base = os.path.join(self.run_dir, test_set, strategy.name)
        dirs = {
            "output": os.path.join(base, "output"),
            "results": os.path.join(base, "results"),
        }
        for p in dirs.values():
            os.makedirs(p, exist_ok=True)
        return dirs

    def results_csv(self, test_set: str, strategy: Strategy) -> str:
        return os.path.join(self.out_dirs(test_set, strategy)["results"], "results.csv")

    def comparisons_csv(self, test_set: str, strategy: Strategy) -> str:
        return os.path.join(self.out_dirs(test_set, strategy)["results"], "comparisons.csv")

    def timings_csv(self, test_set: str, strategy: Strategy) -> str:
        """Per-grid-point wall times, in a file of their own so that the
        17-column comparisons.csv stays byte-compatible."""
        return os.path.join(self.out_dirs(test_set, strategy)["results"], "timings.csv")

    # --- main loop ---------------------------------------------------------
    def run_test_set(self, test_set: str, strategy: Optional[Strategy] = None) -> list:
        strategy = strategy or self.config.strategy
        ts_dir = os.path.join(self.config.test_image_dir, test_set)
        images = sorted(f for f in os.listdir(ts_dir) if os.path.splitext(f)[1].lower() in _IMAGE_EXTS)
        done = self._load_done(test_set, strategy)
        dirs = self.out_dirs(test_set, strategy)
        results_csv = self.results_csv(test_set, strategy)
        comparisons_csv = self.comparisons_csv(test_set, strategy)
        timings_csv = self.timings_csv(test_set, strategy)
        write_csv_header(results_csv, IMAGE_FILE_DATA_HEADER)
        write_csv_header(comparisons_csv, COMPARISON_RESULT_HEADER)
        write_csv_header(timings_csv, TIMINGS_HEADER)

        ctx = {
            "test_set": test_set,
            "strategy": strategy,
            "dirs": dirs,
            "comparisons_csv": comparisons_csv,
            "timings_csv": timings_csv,
        }

        if self.config.mesh:
            return self._run_mesh(ctx, ts_dir, images, done, results_csv)

        all_rows = []
        for image_name in images:
            img_path = os.path.join(ts_dir, image_name)
            meta = read_image_metadata(img_path, test_set=test_set, commit=strategy.name)
            append_rows(results_csv, [meta.csv_row()])
            rgb = read_image(img_path)
            stem = os.path.splitext(image_name)[0]

            for e in self.config.efforts:
                todo = [d for d in self.config.distances if (image_name, d, e) not in done]
                if not todo:
                    continue
                # the row's lossy distances encode as one grid call; d = 0
                # (true lossless, legacy grid) through encode_image
                lossless_ds = [d for d in todo if d <= 0.0]
                lossy_ds = [d for d in todo if d > 0.0]
                sig = (rgb.shape, int(e), strategy.name, len(lossy_ds), bool(lossless_ds))
                warm = 1 if sig in self._warm_sigs else 0
                self._warm_sigs.add(sig)
                t0 = time.perf_counter()
                try:
                    cfg = CodecConfig(effort=int(e), strategy=strategy)
                    datas_by_d = {}
                    if lossy_ds:
                        grid = encode_image_grid(rgb, cfg, lossy_ds, orig_name=image_name, device=self.device)
                        datas_by_d.update(zip(lossy_ds, grid))
                    for d in lossless_ds:
                        datas_by_d[d] = encode_image(
                            rgb,
                            CodecConfig(distance=0.0, effort=int(e), strategy=strategy),
                            orig_name=image_name,
                            device=self.device,
                        )
                    datas = [datas_by_d[d] for d in todo]
                except Exception as exc:  # skip-on-failure (benchmark.rs:661-677)
                    print(f"[sweep] grid encode failed for {stem} e{e}: {exc!r}; skipping")
                    continue
                encode_s = (time.perf_counter() - t0) / max(1, len(todo))
                all_rows.extend(self._finish_row(ctx, image_name, meta, rgb, e, todo, datas, encode_s, warm))
        return all_rows

    def _run_mesh(self, ctx, ts_dir: str, images: list, done: set, results_csv: str) -> list:
        """Mesh mode: batches of mesh-"data"-size same-geometry images
        encode per effort through `encode_grid_sharded`. Rows stay whole: a
        row with any point missing is encoded again in full, and only its
        missing points are finished. d <= 0 points go through
        `encode_image`."""
        from jxl_tpu_torch.distributed.sharded import encode_grid_sharded

        test_set, strategy = ctx["test_set"], ctx["strategy"]
        mesh = parse_mesh_spec(self.config.mesh, self.device)
        n_data = mesh.shape["data"]
        metas, rgbs, by_geom = {}, {}, {}
        for name in images:
            img_path = os.path.join(ts_dir, name)
            metas[name] = read_image_metadata(img_path, test_set=test_set, commit=strategy.name)
            append_rows(results_csv, [metas[name].csv_row()])
            rgbs[name] = read_image(img_path)
            by_geom.setdefault(rgbs[name].shape, []).append(name)

        lossy_ds = [d for d in self.config.distances if d > 0.0]
        all_rows = []
        for e in self.config.efforts:
            cfg = CodecConfig(effort=int(e), strategy=strategy)
            for geom, geom_names in by_geom.items():
                for i in range(0, len(geom_names), n_data):
                    batch = [
                        n for n in geom_names[i : i + n_data]
                        if any((n, d, e) not in done for d in self.config.distances)
                    ]
                    if not batch:
                        continue
                    sig = ("mesh", geom, int(e), strategy.name, len(lossy_ds), len(batch))
                    warm = 1 if sig in self._warm_sigs else 0
                    self._warm_sigs.add(sig)
                    t0 = time.perf_counter()
                    try:
                        grids = encode_grid_sharded([rgbs[n] for n in batch], cfg, lossy_ds, mesh=mesh, orig_names=batch)
                    except Exception as exc:  # skip-on-failure
                        print(f"[sweep] mesh encode failed for batch {batch} e{e}: {exc!r}; skipping")
                        continue
                    encode_s = (time.perf_counter() - t0) / max(1, len(batch) * len(lossy_ds))
                    for name, datas in zip(batch, grids):
                        todo = [d for d in self.config.distances if d <= 0.0 and (name, d, e) not in done]
                        blobs = [
                            encode_image(
                                rgbs[name], CodecConfig(distance=0.0, effort=int(e), strategy=strategy),
                                orig_name=name, device=self.device,
                            )
                            for _d in todo
                        ]
                        for d, blob in zip(lossy_ds, datas):
                            if (name, d, e) not in done:
                                todo.append(d)
                                blobs.append(blob)
                        all_rows.extend(
                            self._finish_row(ctx, name, metas[name], rgbs[name], e, todo, blobs, encode_s, warm)
                        )
        return all_rows

    def _finish_row(self, ctx, image_name, meta, rgb, e, todo, datas, encode_s, warm=1):
        """Decode + metric battery + CSV rows for one (image, effort) row of
        encoded containers."""
        if not todo:
            return []
        test_set, strategy = ctx["test_set"], ctx["strategy"]
        dirs = ctx["dirs"]
        comparisons_csv, timings_csv = ctx["comparisons_csv"], ctx["timings_csv"]
        stem = os.path.splitext(image_name)[0]
        dev = self.device

        rgb_dev = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)  # the original, uploaded once
        legacy = self.config.decompress or self.config.compare_images
        # A uniform row decodes to one [N, H, W, 3] stack and the battery
        # scores the stack in one pass; a mixed row decodes and scores per
        # point. Decode and metric wall times are measured separately.
        t1 = time.perf_counter()
        stacked = decode_bytes_grid_stacked(datas, device=dev)
        outs = None
        if stacked is None:  # mixed coding families / palette points: per-stream decodes
            outs = [decode_stream_device(read_container(b), device=dev) for b in datas]
        _sync(dev)
        decode_s = (time.perf_counter() - t1) / max(1, len(todo))

        t2 = time.perf_counter()
        if stacked is not None:
            metrics = metric_battery_grid_async(rgb_dev, stacked)()
            host_px = stacked.cpu().numpy() if legacy else None
        else:
            pending = [metric_battery_async(rgb_dev, o) for o in outs]
            metrics = [f() for f in pending]
            host_px = np.stack([o.cpu().numpy() for o in outs]) if legacy else None
        _sync(dev)
        rows_meta = []
        for (d, data), m in zip(zip(todo, datas), metrics):
            comp_name = f"{stem}-{d}-{e}.jxt"
            if self.config.keep_artifacts:
                with open(os.path.join(dirs["output"], comp_name), "wb") as f:
                    f.write(data)
            rows_meta.append((d, data, comp_name, m))
        metrics_s = (time.perf_counter() - t2) / max(1, len(todo))

        if legacy:
            self._legacy_stages(ctx, image_name, meta, rgb, e, todo, datas, host_px)

        mp = rgb.shape[0] * rgb.shape[1] / 1e6
        append_rows(
            timings_csv,
            [
                [
                    image_name,
                    d,
                    e,
                    f"{encode_s:.6f}",
                    f"{decode_s:.6f}",
                    f"{metrics_s:.6f}",
                    f"{mp / encode_s:.3f}",
                    f"{mp / decode_s:.3f}",
                    warm,
                ]
                for d in todo
            ],
        )

        rows = []
        for d, data, comp_name, m in rows_meta:
            row = self._compare_to_orig(meta, comp_name, m, len(data), d, e)
            append_rows(comparisons_csv, [row.row()])
            self._mark_done(test_set, strategy, image_name, d, e)
            rows.append(row)
            print(
                f"[sweep] {test_set}/{comp_name}: "
                f"bpp={len(data) * 8 / (rgb.shape[0] * rgb.shape[1]):.3f} "
                f"psnr={row.psnr:.2f} enc={mp / encode_s:.2f}MP/s "
                f"dec={mp / decode_s:.2f}MP/s metrics={metrics_s * 1e3:.1f}ms"
            )
        return rows

    def _legacy_stages(self, ctx, image_name, meta, rgb, e, todo, datas, host_px):
        """Legacy-pipeline stages the Rust harness dropped:

        --decompress: write each decoded image as PNG into decompressed/
        and append a 16-col row to decompressed.csv (decompressed size vs
        original AND vs compressed). --compare-images: write amplified
        |orig - decoded| diff images into diffs/. host_px: [N, H, W, 3] u8
        host pixels (fetched once for the whole row)."""
        test_set, strategy = ctx["test_set"], ctx["strategy"]
        base = os.path.join(self.run_dir, test_set, strategy.name)
        stem = os.path.splitext(image_name)[0]
        orig_fmt = os.path.splitext(image_name)[1].lstrip(".").upper() or "PNG"
        h_px, w_px = rgb.shape[0], rgb.shape[1]

        dec_rows = []
        for i, (d, data) in enumerate(zip(todo, datas)):
            px = host_px[i]
            comp_path = os.path.join(base, "output", f"{stem}-{d}-{e}.jxt")
            if self.config.decompress:
                dec_dir = os.path.join(base, "decompressed")
                os.makedirs(dec_dir, exist_ok=True)
                dec_path = os.path.join(dec_dir, f"{stem}-{d}-{e}.png")
                write_image(dec_path, px)
                dec_size = os.path.getsize(dec_path)
                dec_rows.append(
                    [
                        os.path.join(self.config.test_image_dir, test_set, image_name),
                        comp_path,
                        dec_path,
                        e,
                        d,
                        f"{w_px}x{h_px}",
                        meta.file_size,
                        orig_fmt,
                        len(data),
                        "JXT",
                        dec_size,
                        "PNG",
                        dec_size - meta.file_size,
                        f"{dec_size / max(meta.file_size, 1) * 100:.4f}",
                        dec_size - len(data),
                        f"{dec_size / max(len(data), 1) * 100:.4f}",
                    ]
                )
            if self.config.compare_images:
                diff_dir = os.path.join(base, "diffs")
                os.makedirs(diff_dir, exist_ok=True)
                diff = np.abs(rgb.astype(np.int16) - px.astype(np.int16))
                amp = np.clip(diff * 8, 0, 255).astype(np.uint8)
                write_image(os.path.join(diff_dir, f"{stem}-{d}-{e}-diff.png"), amp)
        if dec_rows:
            dec_csv = os.path.join(base, "results", "decompressed.csv")
            write_csv_header(dec_csv, DECOMPRESSION_HEADER)
            append_rows(dec_csv, dec_rows)

    def _compare_to_orig(self, meta, comp_name, m, comp_size, d, e) -> ComparisonResult:
        """ComparisonResult row from a fetched metric battery dict
        (reference: `benchmark.rs:895-975`)."""
        raw = meta.raw_size
        return ComparisonResult(
            orig_image_name=meta.image_name,
            comp_image_name=comp_name,
            distance=float(d),
            effort=int(e),
            orig_file_size=meta.file_size,
            comp_file_size=comp_size,
            orig_raw_size=raw,
            comp_raw_size=raw,
            comp_file_size_ratio=file_size_ratio(meta.file_size, comp_size),
            raw_file_size_ratio=file_size_ratio(raw, comp_size),
            mse=m["mse"],
            psnr=m["psnr"],
            ssim=m["ssim"],
            ms_ssim=m["ms_ssim"],
            butteraugli=m["butteraugli"],
            butteraugli_pnorm=m["butteraugli_pnorm"],
            ssimulacra2=m["ssimulacra2"],
        )
