#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (jxl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root and needs one CUDA card. Phases, each
printing a line of its own; any miss raises, so the exit code is nonzero
and no result line is printed:

1. card:   nvidia-smi name / power limit and torch's device name;
2. build:  both rANS kernels (jxl_tpu_torch/csrc/*.cu) with nvcc, timed;
3. kernels vs plain at the bench shapes (the port's own token stream of
           the 512x768 bench image: lanes 256, T 4731, 765 contexts):
           encode kernel and both decode phases (with the carry) must equal
           their plain torch versions bit for bit; both timed with CUDA
           events;
4. main path: encode_image + decode_bytes of the bench image at d=1 e7 on
           the card; the kernels must have run (launch counts), PSNR / bpp
           must match the quality anchor, and the card's pixels must be
           within 1 LSB of the plain path on the CPU;
5. times:  warm single-image encode and decode throughput.

The last two lines are a JSON summary of the kernels and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# quality anchor of the bench image at d=1, e7 (hardware-independent)
ANCHOR_PSNR_DB = 38.43
ANCHOR_BPP = 1.5313
PSNR_TOL_DB = 0.05
BPP_TOL_REL = 0.005


def bench_image(h: int = 512, w: int = 768, seed: int = 0) -> np.ndarray:
    """The repository's bench image (bench.py:synth_kodak): a synthetic
    Kodak-sized photo-like RGB u8 image made from a seed."""
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


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(10.0 * np.log10(255.0 * 255.0 / np.mean(d * d)))


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_diff(pairs) -> int:
    """Largest |a - b| over pairs of integer tensors; raises on a shape mismatch."""
    worst = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
        worst = max(worst, int((a.to("cpu").long() - b.to("cpu").long()).abs().max()))
    return worst


def front_packed(torch, bucket, counts):
    """Back-filled encode buckets [G, cap] -> decode buffers with each
    group's stream at the front of its row."""
    G, cap = bucket.shape
    c = counts.tolist()
    out = torch.zeros((G, max(1, max(c))), dtype=torch.int32, device=bucket.device)
    for g in range(G):
        out[g, : c[g]] = bucket[g, cap - c[g] :]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda:0")
    print(f"[1 card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_bytes, decode_bytes_device, decode_values
    from jxl_tpu_torch.codec.encode import (
        _step_ctx_v8,
        encode_image,
        entropy_inputs,
        pick_lanes,
        tokens_from_rgb,
    )
    from jxl_tpu_torch.codec.layout import padded_layout, token_layout
    from jxl_tpu_torch.core.device import resolve_device
    from jxl_tpu_torch.cuda_build import BUILD_LOGS, build
    from jxl_tpu_torch.entropy import cuda_rans_enc
    from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_cuda
    from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda, encode_grouped_plain
    from jxl_tpu_torch.entropy.grouped import decode_grouped

    resolve_device(dev)

    # ---- 2. build
    t0 = time.perf_counter()
    for name in ("rans_dec", "rans_enc"):
        build(name)
    build_s = time.perf_counter() - t0
    print(f"[2 build] rans_dec + rans_enc built in {build_s:.2f} s")
    for name, log in BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 build] {name}: {line.strip()}")

    # ---- 3. kernels vs plain at the bench shapes
    img = bench_image()
    h, w = img.shape[:2]
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], 256)
    lay = padded_layout(h, w, lanes)
    T, t_a = lay["T"], lay["t_a"]
    G = lanes // 128
    token, _nb, mant, _params, q_sorted, _vals = tokens_from_rgb(
        torch.from_numpy(img).to(dev), 1.0, height=h, width=w, effort=7
    )
    tokp, mantp, rows, _freq = entropy_inputs(token, mant, _step_ctx_v8(lay, q_sorted), lay, lanes)
    capw, capm = enc_caps(T, lanes)
    print(
        f"[3 shapes] {h}x{w}: {lay['n_tokens']} tokens, lanes {lanes} (G={G}), T {T} "
        f"(phase A {t_a}, phase B {T - t_a}), caps ({capw}, {capm})"
    )

    kw = dict(T=T, lanes=lanes, capw=capw, capm=capm)
    enc_k = encode_grouped_cuda(tokp, mantp, rows, **kw)
    enc_p = encode_grouped_plain(tokp, mantp, rows, **kw)
    torch.cuda.synchronize()
    enc_err = max_abs_diff(zip(enc_k, enc_p))
    if enc_err != 0:
        raise AssertionError(f"encode kernel differs from its plain version (max |d| {enc_err})")
    enc_ms = cuda_ms(torch, lambda: cuda_rans_enc._launch(tokp, mantp, rows, **kw), 20)
    enc_plain_ms = cuda_ms(torch, lambda: encode_grouped_plain(tokp, mantp, rows, **kw), 2)
    print(f"[3 encode kernel] bit-exact vs plain; kernel {enc_ms:.3f} ms, plain {enc_plain_ms:.1f} ms")

    words_g = front_packed(torch, enc_k[0], enc_k[3])
    mant_g = front_packed(torch, enc_k[1], enc_k[4])
    states = enc_k[2]
    ptr0 = torch.zeros((2, G), dtype=torch.int32, device=dev)
    rows_a, rows_b = rows[:t_a].contiguous(), rows[t_a:].contiguous()

    def decode_both(fn):
        va, st, p = fn(words_g, mant_g, states, rows_a, ptr0, T=t_a, lanes=lanes)
        vb, st2, p2 = fn(words_g, mant_g, st, rows_b, p, T=T - t_a, lanes=lanes)
        return va, st, p, vb, st2, p2

    dec_k = decode_both(decode_grouped_cuda)
    dec_p = decode_both(decode_grouped)
    torch.cuda.synchronize()
    dec_err = max_abs_diff(zip(dec_k, dec_p))
    if dec_err != 0:
        raise AssertionError(f"decode kernel differs from its plain version (max |d| {dec_err})")
    nbits = torch.where(tokp >= 32, tokp - 27, 0)
    expect = torch.where(tokp >= 32, (1 << nbits) + mantp, tokp)
    if not torch.equal(torch.cat([dec_k[0], dec_k[3]]), expect):
        raise AssertionError("decode kernel does not return the encoded values")
    if not torch.equal(dec_k[5], torch.stack([enc_k[3], enc_k[4]])):
        raise AssertionError("decode kernel did not consume exactly the encoded streams")
    dec_ms = cuda_ms(torch, lambda: decode_both(decode_grouped_cuda), 20)
    dec_plain_ms = cuda_ms(torch, lambda: decode_both(decode_grouped), 2)
    print(
        f"[3 decode kernel] both phases bit-exact vs plain (values, states, pointers); "
        f"kernel {dec_ms:.3f} ms, plain {dec_plain_ms:.1f} ms (A + B)"
    )

    # ---- 4. main path
    cfg = CodecConfig(distance=1.0, effort=7)
    encode_grouped_cuda.launches = 0
    decode_grouped_cuda.launches = 0
    data = encode_image(img, cfg, device=dev)
    out = decode_bytes(data, device=dev)
    torch.cuda.synchronize()
    n_enc, n_dec = encode_grouped_cuda.launches, decode_grouped_cuda.launches
    if n_enc < 1 or n_dec < 2:
        raise AssertionError(f"main path launches: encode {n_enc}, decode {n_dec} (want >= 1, >= 2)")
    if out.shape != img.shape or out.dtype != np.uint8:
        raise AssertionError(f"decoded {out.shape} {out.dtype}, expected {img.shape} uint8")
    q_db = psnr(img, out)
    bpp = len(data) * 8 / (h * w)
    print(
        f"[4 main path] {len(data)} bytes, {bpp:.4f} bpp, PSNR {q_db:.4f} dB "
        f"(anchor {ANCHOR_PSNR_DB} dB at {ANCHOR_BPP} bpp); launches encode {n_enc}, decode {n_dec}"
    )
    if abs(q_db - ANCHOR_PSNR_DB) > PSNR_TOL_DB:
        raise AssertionError(f"PSNR {q_db:.4f} dB not within {PSNR_TOL_DB} dB of {ANCHOR_PSNR_DB}")
    if abs(bpp - ANCHOR_BPP) > BPP_TOL_REL * ANCHOR_BPP:
        raise AssertionError(f"bpp {bpp:.4f} not within {BPP_TOL_REL:.1%} of {ANCHOR_BPP}")
    stream = read_container(data)
    if not torch.equal(decode_values(stream, dev).cpu(), decode_values(stream, "cpu")):
        raise AssertionError("card and CPU decode different value streams")
    out_cpu = decode_bytes(data, device="cpu")
    lsb = int(np.abs(out.astype(np.int32) - out_cpu).max())
    print(f"[4 main path] value stream identical to the CPU plain path; pixels max |d| {lsb} LSB")
    if lsb > 1:
        raise AssertionError(f"card vs CPU pixels differ by {lsb} LSB (> 1)")

    # ---- 5. times
    mp = h * w / 1e6
    reps = 5

    def wall(fn):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return ts

    enc_ts = wall(lambda: encode_image(img, cfg, device=dev))
    dec_ts = wall(lambda: decode_bytes_device(data, device=dev))
    print(
        f"[5 times] {kind} ({smi}): single-image encode "
        f"{mp / np.median(enc_ts):.2f} MP/s (median {1e3 * np.median(enc_ts):.1f} ms, "
        f"min {1e3 * min(enc_ts):.1f} ms), decode {mp / np.median(dec_ts):.2f} MP/s "
        f"(median {1e3 * np.median(dec_ts):.1f} ms, min {1e3 * min(dec_ts):.1f} ms), {reps} warm runs"
    )

    kernels = [
        {
            "name": "rans_decode", "route": "cuda", "source": "jxl_tpu_torch/csrc/rans_dec.cu",
            "replaces": "jxl_tpu/entropy/pallas_rans.py:239", "launches": n_dec,
            "max_abs_err": dec_err, "ms": dec_ms, "plain_ms": dec_plain_ms,
        },
        {
            "name": "rans_encode", "route": "cuda", "source": "jxl_tpu_torch/csrc/rans_enc.cu",
            "replaces": "jxl_tpu/entropy/pallas_rans_enc.py:208", "launches": n_enc,
            "max_abs_err": enc_err, "ms": enc_ms, "plain_ms": enc_plain_ms,
        },
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
