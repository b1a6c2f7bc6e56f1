"""The headline benchmark of the port (counterpart of `bench.py`'s body).

`headline(img, device=...)` runs `bench.py`'s stages on `jxl_tpu_torch`,
in order, at d=1, e7, BASELINE, and returns the dict that `bench_torch.py`
prints as one JSON line:

1. warm-up and quality anchor: `encode_image`, `decode_bytes`, PSNR, bpp
   (the first call of every op and the kernels' build happen here);
2. grid encode cadence: depth-2 pipelining over `iters` rows of `batch`
   points of `encode_image_grid_async`, the priming row and the last
   finalize inside the window; median of `reps` trials and the min-max
   spread. The port's encode synchronises with the host inside
   `tokens_from_rgb`, so rows overlap only in their finalize;
3. grid decode cadence: the same over `decode_bytes_grid_stacked`, each row
   ending in a synchronise;
4. single image: `encode_images` and `decode_bytes_device`, `iters` each;
5. roofline: the least time of one single-image encode and decode, the
   larger of their FLOPs over PEAK_FLOPS (the matrix products they run,
   `count_ops`) and their floor bytes over PEAK_BW (`encode_floor_bytes`,
   `decode_floor_bytes`: from the image's and the stream's shapes, so
   fusing or splitting ops does not move it). The eager byte count
   (`count_ops`) is reported beside it as `*_eager_mb`, not as a bound;
6. device time: on CUDA, one single-image encode and decode, one encode
   row of TRACE_ROW points and the decode of that row, each run three
   times timed and once under `torch.profiler` (`traced`). Per image:
   busy milliseconds (the union of the CUDA kernel intervals of the
   traced run) and the idle share 1 - busy / wall, the wall being the
   median host clock of the runs without the profiler (tracing every
   kernel slows the traced run's host side, so its own wall is reported
   beside it). `*_device_ms` is the rows' busy time per image and
   `*_dispatch_fixed_ms` the row's untraced wall less its busy time. All
   None off CUDA;
7. libjpeg anchor: PIL's JPEG encode + decode of the same image on the
   host, when PIL imports; otherwise its keys are None and `baseline_note`
   says why.

Beside `bench.py`'s keys the dict holds `device` (name and power limit
from `nvidia-smi`, or "cpu"), `launches` (each kernel entry's
launches over the run, `cuda_build.launch_counts`) and `trace` (stage 6's readings).

Nothing here picks a device: `device` is required, and a CUDA device
without a card raises in `resolve_device`.
"""

from __future__ import annotations

import io
import os
import subprocess
import time
from contextlib import contextmanager

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.container import read_container
from jxl_tpu_torch.codec.decode import decode_bytes, decode_bytes_device, decode_bytes_grid_stacked
from jxl_tpu_torch.codec.encode import encode_image, encode_image_grid, encode_image_grid_async, encode_images
from jxl_tpu_torch.codec.layout import padded_layout
from jxl_tpu_torch.core.device import resolve_device
from jxl_tpu_torch.cuda_build import ENTRIES, launch_counts
from jxl_tpu_torch.entropy import kernel_bounds
from jxl_tpu_torch.metrics.quality import calculate_psnr

# NVIDIA H100 SXM data sheet, at its 700 W limit: float32 outside the
# tensor cores (TF32 is off, core/device.py) and HBM3.
PEAK_FLOPS = 67e12
PEAK_BW = 3.35e12
TRACE_ROW = 16  # points of the traced grid rows (bench.py's larger slope row)


def synth_kodak(h=512, w=768, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.55 + 0.25 * np.sin(xx / 41.0) * np.cos(yy / 29.0) + 0.1 * np.sin((xx + yy) / 97.0)
    tex = rng.normal(0, 0.025, (h, w)).astype(np.float32)
    edges = 0.15 * (((xx // 96).astype(np.int32) ^ (yy // 64).astype(np.int32)) % 2)
    lum = np.clip(base + tex + edges, 0, 1)
    rgb = np.stack(
        [lum * (0.85 + 0.15 * np.sin(yy / 83.0)), lum, lum * (0.75 + 0.25 * np.cos(xx / 71.0))],
        axis=-1,
    )
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def load_bench_image():
    """Prefer a real test image if one exists, else synthetic Kodak-like."""
    for root in ("test_images/kodak", "test_images"):
        if os.path.isdir(root):
            for f in sorted(os.listdir(root)):
                if f.lower().endswith((".png", ".ppm")):
                    from jxl_tpu_torch.core.io import read_image

                    img = read_image(os.path.join(root, f))
                    if img.shape[0] >= 256 and img.shape[1] >= 256:
                        return img[:512, :768]
    return synth_kodak()


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of each non-view
    aten op whose tensors lie on `device`'s type."""

    def __init__(self, device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in pytree.tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor) and t.device.type == self.device_type
            )
        return out


class OpCount:
    """What `count_ops` counted: `flops` and `bytes` (filled on exit)."""

    flops = 0
    bytes = 0


@contextmanager
def count_ops(device):
    """Count the FLOPs and bytes of the eager aten ops run inside.

    FLOPs come from `torch.utils.flop_counter.FlopCounterMode`, which counts
    matrix products and convolutions only (2mnk for an [m, k] x [k, n]
    product); elementwise work, reductions and scans count 0. Bytes are the
    eager analogue of XLA's per-op "bytes accessed": for every aten op that
    is not a view (`OpOverload.is_view`), the bytes of each tensor operand
    and result on `device`'s type, as if each op read its inputs from and
    wrote its outputs to device memory. It grows with every op boundary:
    fusing ops lowers it, and ops whose tensors fit in the 50 MB L2 may
    never touch HBM, so it is neither a bound nor a yardstick
    (`encode_floor_bytes` is). The ctypes-bound rANS kernels are invisible
    to the dispatcher; callers add their bytes (`entropy/kernel_bounds.py`)."""
    res = OpCount()
    bytes_mode = _ByteCounter(device)
    flops_mode = FlopCounterMode(display=False)
    with flops_mode, bytes_mode:
        yield res
    res.flops = flops_mode.get_total_flops()
    res.bytes = bytes_mode.bytes


def encode_floor_bytes(h: int, w: int, T: int, lanes: int, n_words: int, n_mbytes: int, out_bytes: int) -> int:
    """Bytes any encode of an h x w RGB u8 image into this stream format
    must move, whatever its op split: the image read once, the tokens and
    mantissas [T * lanes] int32 written once (the back-to-front rANS pass
    starts only when every token and the histograms exist), B3's own bytes
    (`kernel_bounds.encode_bytes`: those read back, the rows, the n_words
    words and n_mbytes mantissa bytes written) and the container's
    out_bytes written once."""
    return h * w * 3 + 2 * T * lanes * kernel_bounds.WORD + kernel_bounds.encode_bytes(T, lanes, n_words, n_mbytes) + out_bytes


def decode_floor_bytes(h: int, w: int, T: int, lanes: int, n_words: int, n_mbytes: int, in_bytes: int) -> int:
    """Bytes any decode of such a stream to an h x w RGB u8 image must move:
    the container's in_bytes read once, B1's bytes over the whole stream
    (`kernel_bounds.decode_bytes`: words and mantissa bytes read, values
    [T * lanes] int32 written), the values read back once by the
    reconstruction and the image written once."""
    return in_bytes + kernel_bounds.decode_bytes(T, lanes, n_words, n_mbytes) + T * lanes * kernel_bounds.WORD + h * w * 3


def busy_ms(intervals) -> float:
    """Milliseconds covered by the union of (start_ns, end_ns) intervals."""
    total, covered = 0, None
    for s, e in sorted(intervals):
        if covered is not None:
            s = max(s, covered)
        if e > s:
            total += e - s
            covered = e
    return total / 1e6


def kernel_intervals(events) -> list:
    """(start_ns, end_ns) of every CUDA kernel among a profiler's kineto
    events: the device's events less its memory copies and sets, which
    CUPTI names "Memcpy ..." and "Memset ..."."""
    return [
        (e.start_ns(), e.end_ns())
        for e in events
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.name().startswith(("Memcpy", "Memset"))
    ]


def traced(fn, dev: torch.device, n: int):
    """Run fn on CUDA `dev` three times untraced, each timed on the host
    clock ending in a synchronise (the wall is their median), then once
    under torch.profiler; per image of `n`: the traced run's busy ms (union
    of its kernel intervals), the wall, the idle share 1 - busy / wall, the
    traced run's own wall (the profiler's cost included) and its kernel
    count. Returns (the traced run's result, that dict)."""
    from torch.profiler import ProfilerActivity, profile

    def timed():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3

    wall = sorted(timed()[1] for _ in range(3))[1]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, traced_wall = timed()
    spans = kernel_intervals(prof.profiler.kineto_results.events())
    busy = busy_ms(spans)
    return out, {
        "images": n, "busy_ms": round(busy / n, 4), "wall_ms": round(wall / n, 4),
        "idle_share": round(1.0 - busy / wall, 4), "traced_wall_ms": round(traced_wall / n, 4),
        "kernels": len(spans),
    }


def smi_line(dev: torch.device) -> str:
    """CUDA `dev`'s name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them, the card picked by
    its UUID (torch's device index need not be nvidia-smi's when
    CUDA_VISIBLE_DEVICES reorders or hides cards) and held to torch's name
    for it."""
    uuid = torch.cuda.get_device_properties(dev).uuid
    line = subprocess.run(
        ["nvidia-smi", "-i", f"GPU-{uuid}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if line.rsplit(",", 1)[0].strip() != torch.cuda.get_device_name(dev):
        raise RuntimeError(f"nvidia-smi reports {line!r} for GPU-{uuid}, torch {torch.cuda.get_device_name(dev)!r}")
    return line


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit (W) from `smi_line`; "cpu" off CUDA."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    name, limit = (v.strip() for v in smi_line(dev).rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0])}


def jpeg_trials(img: np.ndarray, reps: int):
    """Sorted seconds per PIL JPEG (quality 90) encode + decode of img, one
    per trial of 5 round trips (bench.py's anchor); None without PIL."""
    try:
        from PIL import Image
    except ImportError:
        return None
    pim = Image.fromarray(np.asarray(img))

    def trial() -> float:
        t0 = time.perf_counter()
        for _ in range(5):
            buf = io.BytesIO()
            pim.save(buf, "JPEG", quality=90)
            buf.seek(0)
            np.asarray(Image.open(buf))
        return (time.perf_counter() - t0) / 5

    return sorted(trial() for _ in range(reps))


def headline(img: np.ndarray, *, device, batch: int = 32, reps: int = 5, iters: int = 6) -> dict:
    """bench.py's measurement of the port on `device` (see the module
    docstring); returns the JSON dict."""
    dev = resolve_device(device)
    card = card_info(dev)
    launches0 = launch_counts()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    h, w = img.shape[:2]
    mp = h * w / 1e6
    cfg = CodecConfig(distance=1.0, effort=7)

    # 1. warm-up and quality anchor
    data = encode_image(img, cfg, device=dev)
    out = decode_bytes(data, device=dev)
    psnr = calculate_psnr(img, out, device=dev)
    bpp = len(data) * 8 / (h * w)

    # 2. grid encode cadence at depth 2 (one warm-up row: the port keeps no
    # history window to adopt)
    dists = [1.0] * batch
    datas = encode_image_grid(img, cfg, dists, device=dev)

    def enc_trial() -> float:
        sync()
        t0 = time.perf_counter()
        fin = encode_image_grid_async(img, cfg, dists, device=dev)
        for _ in range(iters - 1):
            nxt = encode_image_grid_async(img, cfg, dists, device=dev)
            fin()
            fin = nxt
        fin()
        return (time.perf_counter() - t0) / (iters * batch)

    enc_trials = sorted(enc_trial() for _ in range(reps))
    t_enc = enc_trials[len(enc_trials) // 2]

    # 3. grid decode cadence
    decode_bytes_grid_stacked(datas, device=dev)
    sync()

    def dec_trial() -> float:
        # bench.py's ready_wait(prev) after dispatching the next row: the
        # synchronise also waits for that row
        t0 = time.perf_counter()
        decode_bytes_grid_stacked(datas, device=dev)
        for _ in range(iters - 1):
            decode_bytes_grid_stacked(datas, device=dev)
            sync()
        sync()
        return (time.perf_counter() - t0) / (iters * batch)

    dec_trials = sorted(dec_trial() for _ in range(reps))
    t_dec = dec_trials[len(dec_trials) // 2]

    # 4. single image
    encode_images([(img, cfg, "")] * 2, device=dev)
    t0 = time.perf_counter()
    datas1 = encode_images([(img, cfg, "")] * iters, device=dev)
    t_enc1 = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        decode_bytes_device(datas1[-1], device=dev)
    sync()
    t_dec1 = (time.perf_counter() - t0) / iters

    # 5. roofline: FLOPs counted, bytes from the shapes; the eager count
    # plus the rANS kernels' bytes where they launched (off CUDA their plain
    # versions run as counted aten ops) beside it
    stream = read_container(data)
    lanes = stream.header.lanes
    T = padded_layout(h, w, lanes)["T"]
    n_words, n_mbytes = int(stream.wcounts.sum()), int(stream.mcounts.sum())
    n3 = launch_counts()["rans_encode"]
    with count_ops(dev) as enc_ops:
        encode_image(img, cfg, device=dev)
    eager_e = enc_ops.bytes + (launch_counts()["rans_encode"] - n3) * kernel_bounds.encode_bytes(T, lanes, n_words, n_mbytes)
    n1 = launch_counts()["rans_decode"]
    with count_ops(dev) as dec_ops:
        decode_bytes_device(data, device=dev)
        sync()
    eager_d = dec_ops.bytes
    if launch_counts()["rans_decode"] > n1:  # B1's two launches (phases A and B) move one whole stream
        eager_d += kernel_bounds.decode_bytes(T, lanes, n_words, n_mbytes)
    fe, fd = enc_ops.flops, dec_ops.flops
    be = encode_floor_bytes(h, w, T, lanes, n_words, n_mbytes, len(data))
    bd = decode_floor_bytes(h, w, T, lanes, n_words, n_mbytes, len(data))
    enc_min = max(fe / PEAK_FLOPS, be / PEAK_BW)
    dec_min = max(fd / PEAK_FLOPS, bd / PEAK_BW)

    # 6. device time, traced after the untraced timings
    trace = None
    if dev.type == "cuda":
        _, enc1_tr = traced(lambda: encode_image(img, cfg, device=dev), dev, 1)
        _, dec1_tr = traced(lambda: decode_bytes_device(data, device=dev), dev, 1)
        row, enc_tr = traced(lambda: encode_image_grid(img, cfg, [1.0] * TRACE_ROW, device=dev), dev, TRACE_ROW)
        _, dec_tr = traced(lambda: decode_bytes_grid_stacked(row, device=dev), dev, TRACE_ROW)
        trace = {"encode_single": enc1_tr, "decode_single": dec1_tr, "encode_row": enc_tr, "decode_row": dec_tr}

    def device_fields(t, light_s):
        """(ms, lightspeed share, row wall less busy) of a traced row."""
        if t is None:
            return None, None, None
        return t["busy_ms"], round(light_s * 1e3 / t["busy_ms"], 4), round((t["wall_ms"] - t["busy_ms"]) * t["images"], 3)

    enc_dev_ms, enc_dev_frac, enc_fixed_ms = device_fields(trace and trace["encode_row"], enc_min)
    dec_dev_ms, dec_dev_frac, dec_fixed_ms = device_fields(trace and trace["decode_row"], dec_min)

    # 7. libjpeg anchor
    jpeg = jpeg_trials(img, reps)
    jpeg_mps = None if jpeg is None else mp / jpeg[len(jpeg) // 2]

    mps = mp / (t_enc + t_dec)
    result = {
        "metric": f"encode+decode MP/s on {card['name']} (VarDCT d=1)",
        "value": round(mps, 3),
        "unit": "MP/s",
        "vs_baseline": None if jpeg_mps is None else round(mps / jpeg_mps, 3),
        "encode_mps": round(mp / t_enc, 3),
        "decode_mps": round(mp / t_dec, 3),
        "encode_mps_single": round(mp / t_enc1, 3),
        "decode_mps_single": round(mp / t_dec1, 3),
        "grid_batch": batch,
        "reps": reps,
        "encode_mps_spread": [round(mp / enc_trials[-1], 3), round(mp / enc_trials[0], 3)],
        "decode_mps_spread": [round(mp / dec_trials[-1], 3), round(mp / dec_trials[0], 3)],
        "jpeg_cpu_mps_spread": None if jpeg is None else [round(mp / jpeg[-1], 3), round(mp / jpeg[0], 3)],
        "psnr_db": round(psnr, 2),
        "bpp": round(bpp, 4),
        "jpeg_cpu_mps_measured": None if jpeg_mps is None else round(jpeg_mps, 3),
        "vs_jpeg_cpu": None if jpeg_mps is None else round(mps / jpeg_mps, 3),
        "roofline": {
            "peak_flops": PEAK_FLOPS,
            "peak_hbm_bw": PEAK_BW,
            "encode_gflops": round(fe / 1e9, 2),
            "encode_hbm_mb": round(be / 1e6, 3),
            "encode_eager_mb": round(eager_e / 1e6, 1),
            "encode_lightspeed_ms": round(enc_min * 1e3, 4),
            "encode_roofline_frac": round(enc_min / t_enc, 6) if t_enc else 0,
            "decode_gflops": round(fd / 1e9, 2),
            "decode_hbm_mb": round(bd / 1e6, 3),
            "decode_eager_mb": round(eager_d / 1e6, 1),
            "decode_lightspeed_ms": round(dec_min * 1e3, 4),
            "decode_roofline_frac": round(dec_min / t_dec, 6) if t_dec else 0,
            "encode_device_ms": enc_dev_ms,
            "encode_device_frac": enc_dev_frac,
            "encode_dispatch_fixed_ms": enc_fixed_ms,
            "decode_device_ms": dec_dev_ms,
            "decode_device_frac": dec_dev_frac,
            "decode_dispatch_fixed_ms": dec_fixed_ms,
        },
        "device": card,
        "launches": {k: n - launches0[k] for k, n in launch_counts().items() if not ENTRIES[k].probe},
        "trace": trace,
    }
    if jpeg is None:
        result["baseline_note"] = "PIL is not installed here, so the same-host libjpeg anchor was not measured"
    return result
