#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (jxl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root and needs one CUDA card. Phases, each
printing a line of its own; any miss raises, so the exit code is nonzero
and no result line is printed:

1. card:   nvidia-smi name / power limit and torch's device name;
2. build:  the rANS sources, the screen and the chain probe (csrc/*.cu),
           one nvcc each, in parallel, timed; then the probe's SM cycles
           per link of each dependent chain of the scans on this card
           (kernel_bounds.measure_chain_cycles), which the chain bounds
           below are made of;
3. kernels vs plain at the bench shapes (the port's own token stream of
           the 512x768 bench image: lanes 256, T 4731, 765 contexts):
           encode kernel (B3) and both single-stream decode phases (B1, with
           the carry) must equal their plain torch versions bit for bit;
           both kernels timed with CUDA events, each time also in ns and SM
           cycles per step (clocks.sm sampled by nvidia-smi right after the
           window) beside its roofline bound and its chain bound (T x the
           measured step chain at that clock;
           jxl_tpu_torch/entropy/kernel_bounds.py); a plain version's time
           is the host clock around its one compared call;
3b. batched decode kernel (B2) vs plain at the bench shape: grid rows of
           the bench image (10 sweep distances, and 32 points), both phases
           as the grid decode hands them over, bit for bit (values, states,
           pointers); every stream must equal B1's decode; timed against
           its bounds, and on the first 1, 4, 10, 16 and 32 streams of the
           32-point row;
3c. B3 and B1 vs plain on the modular shapes: the d = 0 lossless token
           streams (12 contexts) of the bench image, of
           test_images/synth/synth02.png and of uniform noise of the same
           size (past B3's default mantissa cap: the wrapper must relaunch
           with grown caps); whether B3 relaunched is printed for each; bit
           for bit, timed (plain versions one call each);
3d. the pre-screen kernel (csrc/screen.cu) at 4032x3024, on a photo and
           on graphics, at 4097x4096 (stride 4) and at 768x512: its count
           must equal the plain version's on the card and on the CPU;
           timed with CUDA events (mean of 20 launches, the launch alone
           and the whole screen_count with its zero fill and read-back)
           beside its bound (the frame read once at 3.35 TB/s), the plain
           version's host time, and the plain version on the card (wall,
           busy time, kernels, bytes allocated) against screen_count's;
3e. the DCT kernel D1 (csrc/dct.cu) at the 12 MP views of the encoder's
           8x8, 4x4 and 64x64 calls, forward and inverse: the same bits
           from two launches, within 1e-5 of max|Y| of the cuBLAS path,
           timed with CUDA events (mean of 20 launches) beside its bound
           (one read and one write at 3.35 TB/s, or its FLOPs at 67
           TFLOP/s) and torch.matmul on the same view;
4. main path, single image: encode_image + decode_bytes at d=1 e7 on the
           card; the kernels must have run (launch counts, the screen
           exactly once, as in each 4b row; from here on every phase's D1
           launches must equal what the codec's dct2d / idct2d calls on
           the card take, one a call, two above 64), PSNR / bpp must
           match the quality anchor, and the card's pixels must be within
           1 LSB of the plain path on the CPU;
4b. main path, the sweep row: encode_image_grid + decode_bytes_grid_stacked
           of the bench image over the reference harness's 10 distances at
           e7, under each of the five strategies; one encode launch per
           point, B2 twice per row and B1 never; BASELINE containers equal
           encode_image's, the d=1 point meets the anchor, values and pixels
           equal the per-stream decodes on the card; bytes and PSNR printed
           per point;
4c. main path, efforts 8 and 9: encode_image + decode_bytes of the bench
           image at d=1; B3 and B1 must run, pixels within 1 LSB of the CPU
           plain path's decode; bytes, bpp, PSNR beside e7's;
4d. main path, the modular family at full width on synth02.png (512x768,
           65 colours): d=0 through encode_image must round-trip exactly
           (palette or plain arm printed), so must the bench image at d=0;
           encode_image_grid over the 10 distances with the per-point
           VarDCT-vs-modular pick printed (mode, bytes, PSNR); the modular
           row (`_modular_grid_async`) through decode_bytes_grid_stacked
           with B2 exactly twice and B1 never, values and pixels equal to the
           per-stream decodes, every point within the modular-lossy error
           bound;
5. times:  warm single-image encode and decode throughput: e7, e8, e9 at
           d=1 on the bench image, d=0 of the bench image and synth02.png,
           modular-lossy d=1 of synth02.png;
5b. times: warm grid encode and grid decode throughput, 32 points at d=1;
6. the thesis A/B sweep, in process through `python -m jxl_tpu_torch bench`:
           the 12 images of test_images/synth (512x768) x the 10 sweep
           distances x BASELINE and HOMOGENEITY_PARTITIONING at e7 (240
           points: encode, decode, metric battery, CSVs); every CSV header
           equal to the schema, 120 comparison rows per strategy, the
           summary's MEAN row, B3, B2 and B1 all launched; each image's d=1
           point re-decoded on the CPU and re-scored there by the plain path,
           the CSV's metrics within the bars, its PSNR equal to psnr(); the
           sweep's wall time, per-point medians from timings.csv and the
           battery's time on one 10-point row, card against CPU;
6b. the legacy stages and the effort axis: synth02.png at d in {0, 1, 3} x
           e5-e9 with --decompress --compare-images; d = 0 exact (PSNR inf),
           the decompressed PNGs (stdlib writer) read back equal to the
           decoded pixels;
7. striped JXTS, small, held to the CPU: the bench image in 3 stripes at
           d=1 e7 on the card, decoded on the card and on the CPU from the
           same bytes within 1 LSB; at d=1 and d=3 the striped decode
           against the naive paste of per-section decodes: equal more than
           8 px away from the two seams, and, where the sections signal
           EPF (d=3; at d=1 the encoder's measured decision leaves it off),
           different within 8 px of a seam; a d=0 striped round trip exact;
           a mixed modular / VarDCT container (UI beside photo, 512x768,
           4 stripes) above 30 dB;
7b. striped JXTS at full size: a bench-style image of 8192x8704 (71.3 MP,
           above the single-section cap of 2^26 pixels) written as PPM,
           through encode_file (9 stripes of ~7.9 MP) at d=1 e7, then
           decode_bytes_device; JXTS magic, every section within the cap
           and at 1024 lanes, PSNR above 35 dB, B3 / B1 launches (9 / 18
           unless a relaunch is reported), one section byte-identical to
           encode_image of that stripe alone, peak device memory, encode
           and decode seconds and MP/s; then B3 and B1 on one stripe's
           stream (lanes 1024, T ~23,700): B3 and B1 (both phases: values,
           states, pointers) bit for bit against their plain versions at
           full length, B1 also against the encoded values; timed;
8. mesh:   encode_grid_sharded over 4 images of test_images/synth x the 10
           sweep distances on a data=2 mesh of the card, byte-identical to
           encode_image_grid under modular=False;
           encode_image_striped_sharded of the bench image in 4 stripes
           equal to encode_image_striped; sharded_epf over space=4 slots
           equal to epf_apply; a 2-image `bench --mesh data=2` run whose
           comparisons.csv equals the single-device run's;
9. serve:  `python -m jxl_tpu_torch serve --device cuda:0` on a socket under
           the sweep's directory; encode and decode as fresh client
           processes, forwarded and (JXL_TPU_TORCH_NO_SERVER=1) cold local:
           the files must be equal; process wall of each printed; shutdown,
           and the socket must be gone;
10. standalone: the interleaved rANS coder of entropy/rans.py and the
           MSB-first bit packer of entropy/tokens.py at the bench image's
           stream size (1,211,136 tokens, 765 contexts, alphabet 52, lanes
           256, T 4731; seeded geometric skew, tables from
           quantize_histograms) on the card: words, states, stream bytes and
           packed words equal, bit for bit, the port's on the CPU and the
           native C++ core's (native/jxt_native.cpp, built with g++); the
           card's, the CPU's and the native decoders all return the tokens;
           no kernel launches; host wall of card, CPU and native printed;
11. headline: jxl_tpu_torch/bench/headline.py (what bench_torch.py prints)
           at reps = 2 on the bench image: its JSON and its trace block
           printed; PSNR and bpp must meet the quality anchor, B1, B2 and B3
           must each have launched in it, every traced idle share must lie
           in [0, 1] with kernels found; then the host synchronisations of
           one e7 encode, counted from torch.cuda.set_sync_debug_mode("warn")
           warnings (by source line), and traced e8 and d = 0 encodes, the
           d = 0 decode and the metric battery of the bench image's sweep
           row (10 distances) (busy ms, idle share);
12. tools: the port's measurement tools (jxl_tpu_torch/tools/) in process
           on the card, at full size: profile_stages on the bench image
           (its stage table: wall, busy ms and kernels per stage; the
           full-encode stage's container equal to encode_image's);
           batch_scaling (B = 1..32, B1 at B = 1, B2 above); rd_point on
           the bench image and one corpus-style image, the bench row's d=1
           point held to the quality anchor; bit_breakdown of the bench
           image, its sections summing to the container's payload (words,
           mantissa bytes and the lane states' information) within 1e-3;
           epf_ab on the bench image at d = 1, 4, 8; then one
           profile_startup subprocess (a cold encode of the bench image's
           PNG on cuda:0), every mark positive and its container equal to
           encode_image's. The phase prints its wall time.

The last two lines are a JSON summary of the kernels and the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# quality anchor of the bench image at d=1, e7 (hardware-independent)
ANCHOR_PSNR_DB = 38.43
ANCHOR_BPP = 1.5313
PSNR_TOL_DB = 0.05
BPP_TOL_REL = 0.005

# the reference harness's RD-sweep distance row (jxl_tpu/bench/sweep.py)
RUST_DISTANCES = (0.5, 1.0, 1.5, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0)
GRID_BATCH = 32  # points per grid row that bench.py times
REPO = os.path.dirname(os.path.abspath(__file__))
SYNTH02 = os.path.join(REPO, "test_images", "synth", "synth02.png")
SWEEP_DIR = os.path.join(REPO, "benchmarks", "chip_smoke")  # output of phases 6-9 (git-ignored), emptied first

# the card's metric battery against the plain path on the CPU: the bars of
# tests/test_torch_metrics.py (port vs reference), held here card vs CPU
BAR_MSE_REL = 1e-6
BAR_PSNR_DB = 1e-5
BAR_SSIM_ABS = 1e-5
BAR_BA_MAX_REL = 3e-4
BAR_BA_P3_REL = 1e-4
BAR_S2_ABS = 0.05


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0.0 else float(10.0 * np.log10(255.0 * 255.0 / mse))


def cuda_ms(torch, fn, iters: int, warmup: bool = True) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA events),
    after one warm-up call unless not `warmup`."""
    if warmup:
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


def acs_ids(stream, dev) -> list:
    """The strategy ids a VarDCT container's ACS map uses (its first
    section, decoded on `dev`)."""
    import torch

    from jxl_tpu_torch.codec.decode import decode_values, unpredict_lcol
    from jxl_tpu_torch.codec.layout import token_layout
    from jxl_tpu_torch.entropy.tokens import zigzag_unmap

    h = stream.header
    lay = token_layout(h.height, h.width)
    v = decode_values(stream, dev)[: lay["nb"]].to(torch.int64)
    if (h.decode_params >> 3) & 1:
        v = unpredict_lcol(zigzag_unmap(v).to(torch.int64).reshape(lay["nby"], lay["nbx"]))
    return sorted(set(torch.clamp(v, 0, 8).reshape(-1).tolist()))


def smi_sample() -> dict:
    """The card's SM clock (MHz), power draw and power limit (W) now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    mhz, draw, limit = (float(v) for v in out.split(","))
    return dict(mhz=mhz, draw=draw, limit=limit)


def kernel_time(torch, fn, *, T: int, nbytes: int, step_cycles: float, iters: int = 20) -> dict:
    """fn's CUDA-event mean over `iters` launches (after a warm-up), the SM
    clock sampled right after the window, and the time per step against the
    roofline bound and the chain bound of T steps of `step_cycles` measured
    cycles (jxl_tpu_torch/entropy/kernel_bounds.py)."""
    from jxl_tpu_torch.entropy.kernel_bounds import chain_bound_ms, cycles_per_step, roofline_ms

    ms = cuda_ms(torch, fn, iters)
    s = smi_sample()
    roof, chain = roofline_ms(nbytes), chain_bound_ms(T, step_cycles, s["mhz"])
    return dict(
        ms=ms, T=T, nbytes=nbytes, mhz=s["mhz"], draw=s["draw"], ns_per_step=ms * 1e6 / T,
        cycles_per_step=cycles_per_step(ms, T, s["mhz"]), bound_ms=roof, chain_bound_ms=chain,
    )


def bound_text(k: dict) -> str:
    return (
        f"{k['ms']:.3f} ms, {k['ns_per_step']:.1f} ns = {k['cycles_per_step']:.0f} cycles per step (T {k['T']}, "
        f"SM {k['mhz']:.0f} MHz, {k['draw']:.0f} W drawn); roofline {1e3 * k['bound_ms']:.2f} us "
        f"({k['nbytes'] / 1e6:.3f} MB, {100 * k['bound_ms'] / k['ms']:.2f}%), chain "
        f"{k['chain_bound_ms']:.3f} ms ({100 * k['chain_bound_ms'] / k['ms']:.1f}%)"
    )


def hold_stream(torch, tokp, mantp, rows, *, T: int, t_a: int, lanes: int, label: str, chains: dict):
    """B3, then B1 over both phases (split at t_a, joined by the carry), on
    one padded token stream: each held bit for bit against its plain
    version on every output, the decode also against the encoded values
    and the encoded stream lengths, and each timed with CUDA events against
    its bounds (`chains`: the measured cycles per link). A plain version
    runs once at full length, for the comparison, timed by the host clock
    (a cold call: its first-use warm-up is in the reading). Returns the
    errors, times, and whether B3 relaunched with grown caps."""
    from jxl_tpu_torch.entropy import cuda_rans_enc
    from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_cuda
    from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda, encode_grouped_plain
    from jxl_tpu_torch.entropy.grouped import decode_grouped
    from jxl_tpu_torch.entropy.kernel_bounds import decode_bytes, encode_bytes

    G = lanes // 128
    capw, capm = enc_caps(T, lanes)
    n0 = encode_grouped_cuda.launches
    enc_k = encode_grouped_cuda(tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm)
    relaunched = encode_grouped_cuda.launches - n0 > 1
    kw = dict(T=T, lanes=lanes, capw=enc_k[0].shape[1], capm=enc_k[1].shape[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_p = encode_grouped_plain(tokp, mantp, rows, **kw)
    torch.cuda.synchronize()
    enc_plain_ms = 1e3 * (time.perf_counter() - t0)
    enc_err = max_abs_diff(zip(enc_k, enc_p))
    if enc_err != 0:
        raise AssertionError(f"encode kernel differs from its plain version (max |d| {enc_err})")
    n_words, n_mbytes = int(enc_k[3].sum()), int(enc_k[4].sum())
    enc_t = kernel_time(
        torch, lambda: cuda_rans_enc._launch(tokp, mantp, rows, **kw), T=T,
        nbytes=encode_bytes(T, lanes, n_words, n_mbytes), step_cycles=chains["encode_step"],
    )

    words_g = front_packed(torch, enc_k[0], enc_k[3])
    mant_g = front_packed(torch, enc_k[1], enc_k[4])
    ptr0 = torch.zeros((2, G), dtype=torch.int32, device=tokp.device)
    rows_a, rows_b = rows[:t_a].contiguous(), rows[t_a:].contiguous()

    def decode_both(fn):
        va, st, p = fn(words_g, mant_g, enc_k[2], rows_a, ptr0, T=t_a, lanes=lanes)
        vb, st2, p2 = fn(words_g, mant_g, st, rows_b, p, T=T - t_a, lanes=lanes)
        return va, st, p, vb, st2, p2

    dec_k = decode_both(decode_grouped_cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec_p = decode_both(decode_grouped)
    torch.cuda.synchronize()
    dec_plain_ms = 1e3 * (time.perf_counter() - t0)
    dec_err = max_abs_diff(zip(dec_k, dec_p))
    if dec_err != 0:
        raise AssertionError(f"decode kernel differs from its plain version (max |d| {dec_err})")
    nbits = torch.where(tokp >= 32, tokp - 27, 0)
    expect = torch.where(tokp >= 32, (1 << nbits) + mantp, tokp)
    if not torch.equal(torch.cat([dec_k[0], dec_k[3]]), expect):
        raise AssertionError("decode kernel does not return the encoded values")
    if not torch.equal(dec_k[5], torch.stack([enc_k[3], enc_k[4]])):
        raise AssertionError("decode kernel did not consume exactly the encoded streams")
    wa, ba = (int(v) for v in dec_k[2].sum(dim=1).tolist())
    dec_nbytes = decode_bytes(t_a, lanes, wa, ba) + decode_bytes(T - t_a, lanes, n_words - wa, n_mbytes - ba)
    dec_t = kernel_time(
        torch, lambda: decode_both(decode_grouped_cuda), T=T, nbytes=dec_nbytes, step_cycles=chains["decode_step"]
    )
    print(f"[{label} B3] {bound_text(enc_t)}; plain {enc_plain_ms:.1f} ms")
    print(f"[{label} B1] (A + B) {bound_text(dec_t)}; plain {dec_plain_ms:.1f} ms")
    return dict(
        enc_err=enc_err, dec_err=dec_err, enc=enc_t, enc_plain_ms=enc_plain_ms, dec=dec_t,
        dec_plain_ms=dec_plain_ms, relaunched=relaunched, caps=(kw["capw"], kw["capm"]), default_caps=(capw, capm),
        mbytes=n_mbytes, words=n_words,
    )


def read_csv(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def metrics_within_bars(got: dict, want: dict, what: str) -> dict:
    """Raise unless battery dict `got` is within the bars of `want`;
    returns the differences (relative for MSE and Butteraugli)."""
    rel = lambda k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)  # noqa: E731
    diff = {
        "mse": rel("mse") if want["mse"] > 0 else abs(got["mse"]),
        "psnr": 0.0 if got["psnr"] == want["psnr"] else abs(got["psnr"] - want["psnr"]),
        "ssim": abs(got["ssim"] - want["ssim"]),
        "ms_ssim": abs(got["ms_ssim"] - want["ms_ssim"]),
        "butteraugli": rel("butteraugli") if want["butteraugli"] > 0 else abs(got["butteraugli"]),
        "butteraugli_pnorm": rel("butteraugli_pnorm") if want["butteraugli_pnorm"] > 0 else abs(got["butteraugli_pnorm"]),
        "ssimulacra2": abs(got["ssimulacra2"] - want["ssimulacra2"]),
    }
    bars = {
        "mse": BAR_MSE_REL, "psnr": BAR_PSNR_DB, "ssim": BAR_SSIM_ABS, "ms_ssim": BAR_SSIM_ABS,
        "butteraugli": BAR_BA_MAX_REL, "butteraugli_pnorm": BAR_BA_P3_REL, "ssimulacra2": BAR_S2_ABS,
    }
    for k, bar in bars.items():
        if not diff[k] <= bar:
            raise AssertionError(f"{what}: {k} {got[k]!r} vs {want[k]!r} (difference {diff[k]:.3g} > bar {bar})")
    return diff


def run_bench_cli(argv: list, log: str) -> float:
    """`python -m jxl_tpu_torch bench` in this process, its per-point lines
    into `log`; returns the wall seconds (ending in a synchronize)."""
    import contextlib

    import torch

    from jxl_tpu_torch.cli.main import main as cli

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = cli(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"bench {' '.join(argv)} returned {rc}")
    return time.perf_counter() - t0


def phase_sweep(torch, dev, kind: str, smi: str, reset_counts, read_counts):
    """6: the thesis's A/B sweep through the CLI at the corpus's own size
    (12 images of 512x768 x RUST_DISTANCES x BASELINE and
    HOMOGENEITY_PARTITIONING at e7); the CSVs against the schema, the
    kernels' launches, every image's d = 1 point re-decoded and re-scored
    on the CPU, the times. Returns the sweep's (B3, B1, B2, screen) launches."""
    from jxl_tpu_torch.bench.csv_schema import COMPARISON_DIFF_HEADER, COMPARISON_RESULT_HEADER, IMAGE_FILE_DATA_HEADER
    from jxl_tpu_torch.bench.sweep import TIMINGS_HEADER
    from jxl_tpu_torch.codec.decode import decode_file
    from jxl_tpu_torch.core.io import read_png_rgb8
    from jxl_tpu_torch.metrics.battery import _battery_grid, metric_battery, metric_battery_grid_async

    strategies = ("BASELINE", "HOMOGENEITY_PARTITIONING")
    images = sorted(os.listdir(os.path.join(REPO, "test_images", "synth")))
    bench_dir = os.path.join(SWEEP_DIR, "sweep")
    argv = [
        "bench", "--device", str(dev), "--test-image-dir", os.path.join(REPO, "test_images"),
        "--benchmark-dir", bench_dir, "--distances", *map(str, RUST_DISTANCES), "--efforts", "7",
        "--strategy", strategies[0], "--compare-to", strategies[1],
    ]
    reset_counts()
    wall_s = run_bench_cli(argv, os.path.join(SWEEP_DIR, "sweep.log"))
    ne, n1, n2, ns, nd = read_counts()
    n_pts = len(images) * len(RUST_DISTANCES)
    if ne < 2 * n_pts or n1 < 1 or n2 < 2:
        raise AssertionError(f"sweep launches: B3 {ne}, B1 {n1}, B2 {n2} (want >= {2 * n_pts}, >= 1, >= 2)")
    base = os.path.join(bench_dir, "0", "synth")
    timings = []
    for strat in strategies:
        res = os.path.join(base, strat, "results")
        for name, header, n_rows in (
            ("results.csv", IMAGE_FILE_DATA_HEADER, len(images)),
            ("comparisons.csv", COMPARISON_RESULT_HEADER, n_pts),
            ("timings.csv", TIMINGS_HEADER, n_pts),
        ):
            rows = read_csv(os.path.join(res, name))
            if rows[0] != header or len(rows) - 1 != n_rows:
                raise AssertionError(f"{strat}/{name}: header {rows[0]} with {len(rows) - 1} rows (want {n_rows})")
        timings += [r for r in read_csv(os.path.join(res, "timings.csv"))[1:] if r[8] == "1"]
    diffs = read_csv(os.path.join(base, "comparison_diffs.csv"))
    summary = read_csv(os.path.join(base, "summary.csv"))
    if diffs[0] != COMPARISON_DIFF_HEADER or len(diffs) - 1 != n_pts:
        raise AssertionError(f"comparison_diffs.csv: {len(diffs) - 1} rows")
    if summary[0] != COMPARISON_DIFF_HEADER or len(summary) != 2 or summary[1][0] != "MEAN":
        raise AssertionError(f"summary.csv: {summary}")
    mean = dict(zip(COMPARISON_DIFF_HEADER, summary[1]))
    print(
        f"[6 sweep] {len(images)} images x {len(RUST_DISTANCES)} distances x {len(strategies)} strategies = "
        f"{2 * n_pts} points in {wall_s:.1f} s on {kind} ({smi}); launches B3 {ne}, B2 {n2}, B1 {n1}; CSV headers "
        f"equal the schema, {n_pts} comparison rows per strategy, summary MEAN: bytes "
        f"{float(mean['Diff Compressed File Size']):+.1f}, PSNR {float(mean['Diff PSNR']):+.4f} dB, SSIMULACRA2 "
        f"{float(mean['Diff SSIMULACRA2']):+.4f}"
    )

    # every image's d = 1 point: the .jxt re-decoded on the CPU, the battery re-run there
    worst, lsb_max = {}, 0
    comps = {r[1]: r for r in read_csv(os.path.join(base, strategies[0], "results", "comparisons.csv"))[1:]}
    for name in images:
        stem = os.path.splitext(name)[0]
        row = comps[f"{stem}-1.0-7.jxt"]
        jxt = os.path.join(base, strategies[0], "output", row[1])
        orig = read_png_rgb8(os.path.join(REPO, "test_images", "synth", name))
        card_px = decode_file(jxt, device=dev)
        cpu_px = decode_file(jxt, device="cpu")
        lsb = int(np.abs(card_px.astype(np.int32) - cpu_px).max())
        lsb_max = max(lsb_max, lsb)
        if lsb > 1:
            raise AssertionError(f"{row[1]}: card vs CPU pixels differ by {lsb} LSB")
        csv_m = dict(zip(("mse", "psnr", "ssim", "ms_ssim", "butteraugli", "butteraugli_pnorm", "ssimulacra2"), map(float, row[10:17])))
        # the battery is held on the pixels the card scored; a 1-LSB decode
        # difference would otherwise show as a metric difference
        cpu_m = metric_battery(orig, card_px, device="cpu")
        for k, v in metrics_within_bars(csv_m, cpu_m, row[1]).items():
            worst[k] = max(worst.get(k, 0.0), v)
        if abs(csv_m["psnr"] - psnr(orig, card_px)) > BAR_PSNR_DB:
            raise AssertionError(f"{row[1]}: PSNR column {csv_m['psnr']} vs {psnr(orig, card_px)} (float64)")
    print(
        f"[6 d=1 points] {len(images)} .jxt re-decoded on the CPU (card vs CPU pixels max |d| {lsb_max} LSB), battery "
        "re-run there: card vs CPU max " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + "; PSNR column equals psnr() within 1e-5 dB"
    )

    # times: per point from timings.csv (Warm == 1), the battery on one row
    med = [float(np.median([float(r[i]) for r in timings])) for i in (3, 4, 5)]
    stem0 = os.path.splitext(images[0])[0]
    orig0 = read_png_rgb8(os.path.join(REPO, "test_images", "synth", images[0]))
    stack = torch.stack([
        torch.from_numpy(decode_file(os.path.join(base, strategies[0], "output", f"{stem0}-{d}-7.jxt"), device=dev)).to(dev)
        for d in RUST_DISTANCES
    ])
    orig0_t = torch.from_numpy(orig0).to(dev)
    bat_ms = cuda_ms(torch, lambda: _battery_grid(orig0_t, stack), 10)
    card_rows = metric_battery_grid_async(orig0_t, stack)()
    t0 = time.perf_counter()
    cpu_rows = metric_battery_grid_async(orig0, stack.cpu(), device="cpu")()
    bat_cpu_ms = 1e3 * (time.perf_counter() - t0)
    for d, c, p in zip(RUST_DISTANCES, card_rows, cpu_rows):
        metrics_within_bars(c, p, f"{stem0} d={d} row battery")
    torch.cuda.reset_peak_memory_stats(dev)
    _battery_grid(orig0_t, stack)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(
        f"[6 times] {kind} ({smi}): sweep wall {wall_s:.1f} s for {2 * n_pts} points; per point (median of "
        f"{len(timings)} Warm == 1 rows): encode {med[0] * 1e3:.1f} ms, decode {med[1] * 1e3:.1f} ms, metrics "
        f"{med[2] * 1e3:.1f} ms; battery of one {len(RUST_DISTANCES)}-point row ({stem0}): card {bat_ms:.2f} ms "
        f"(CUDA events, 10 runs, peak {peak_gb:.2f} GB), plain path on the CPU {bat_cpu_ms:.0f} ms (one call); "
        "row within the bars card vs CPU"
    )
    return ne, n1, n2, ns, nd


def phase_legacy(torch, dev, reset_counts, read_counts):
    """6b: the legacy stages and the effort axis on synth02.png: d in
    {0, 1, 3} x e5-e9 with --decompress --compare-images; d = 0 exact (PSNR
    inf), the decompressed PNGs read back equal to the decoded pixels.
    Returns the (B3, B1, B2, screen) launches."""
    from jxl_tpu_torch.bench.sweep import DECOMPRESSION_HEADER
    from jxl_tpu_torch.codec.decode import decode_file
    from jxl_tpu_torch.core.io import read_png_rgb8

    img_dir = os.path.join(SWEEP_DIR, "legacy_images")
    os.makedirs(os.path.join(img_dir, "synth02"))
    shutil.copy(SYNTH02, os.path.join(img_dir, "synth02", "synth02.png"))
    bench_dir = os.path.join(SWEEP_DIR, "legacy")
    dists, efforts = (0.0, 1.0, 3.0), (5, 6, 7, 8, 9)
    argv = [
        "bench", "--device", str(dev), "--test-image-dir", img_dir, "--benchmark-dir", bench_dir,
        "--distances", *map(str, dists), "--efforts", *map(str, efforts), "--decompress", "--compare-images",
    ]
    reset_counts()
    wall_s = run_bench_cli(argv, os.path.join(SWEEP_DIR, "legacy.log"))
    ne, n1, n2, ns, nd = read_counts()
    base = os.path.join(bench_dir, "0", "synth02", "BASELINE")
    comps = read_csv(os.path.join(base, "results", "comparisons.csv"))[1:]
    dec = read_csv(os.path.join(base, "results", "decompressed.csv"))
    n_pts = len(dists) * len(efforts)
    if len(comps) != n_pts or dec[0] != DECOMPRESSION_HEADER or len(dec) - 1 != n_pts:
        raise AssertionError(f"legacy sweep: {len(comps)} comparison rows, {len(dec) - 1} decompressed rows")
    if len(os.listdir(os.path.join(base, "diffs"))) != n_pts:
        raise AssertionError("legacy sweep: missing diff images")
    orig = read_png_rgb8(SYNTH02)
    for r in comps:
        d = float(r[2])
        px = decode_file(os.path.join(base, "output", r[1]), device=dev)
        back = read_png_rgb8(os.path.join(base, "decompressed", r[1][: -len(".jxt")] + ".png"))
        if not np.array_equal(back, px):
            raise AssertionError(f"{r[1]}: the decompressed PNG does not read back as the decoded pixels")
        if d == 0.0 and not (r[11] == "inf" and float(r[10]) == 0.0 and np.array_equal(px, orig)):
            raise AssertionError(f"{r[1]}: d = 0 is not exact (MSE {r[10]}, PSNR {r[11]})")
    by_e = {e: [r for r in comps if int(r[3]) == e] for e in efforts}
    print(
        f"[6b legacy] synth02 d in {dists} x e{efforts[0]}-e{efforts[-1]}: {n_pts} points in {wall_s:.1f} s; launches "
        f"B3 {ne}, B2 {n2}, B1 {n1}; d = 0 exact (PSNR inf) at every effort; {n_pts} decompressed PNGs read back equal "
        "to the decoded pixels; " + "; ".join(
            f"e{e}: " + ", ".join(f"d={float(r[2]):g} {r[5]} B {float(r[11]):.2f} dB" for r in rows) for e, rows in by_e.items()
        )
    )
    return ne, n1, n2, ns, nd


def section_headers(data: bytes) -> list:
    from jxl_tpu_torch.codec.container import read_container_header
    from jxl_tpu_torch.codec.tiled import read_striped

    return [read_container_header(s) for s in read_striped(data)[2]]


def seam_check(striped: np.ndarray, naive: np.ndarray, seams: list, expect_differs: bool, what: str) -> int:
    """Striped decode against the naive paste of per-section decodes: equal
    more than 8 px away from every seam; within 8 px of one, different
    somewhere iff `expect_differs`. Returns the number of differing columns."""
    cols = np.arange(striped.shape[1])
    near = np.zeros(striped.shape[1], bool)
    for x in seams:
        near |= np.abs(cols - x + 0.5) <= 8
    differs = (striped != naive).any(axis=(0, 2))
    if differs[~near].any():
        raise AssertionError(f"{what}: striped decode differs from the per-section paste away from the seams")
    if bool(differs[near].any()) != expect_differs:
        raise AssertionError(f"{what}: seam columns {'equal' if expect_differs else 'differ from'} the naive paste")
    return int(differs.sum())


def phase_striped_small(torch, dev, img, reset_counts, read_counts):
    """7: striped containers at the bench size, held to the CPU. Returns the
    (B3, B1, B2, screen) launches of the card's encodes and decodes."""
    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.tiled import encode_image_striped, is_striped, read_striped, stripe_widths

    h, w = img.shape[:2]
    n = 3
    seams = [int(x) for x in np.cumsum(stripe_widths(w, n))[:-1]]
    reset_counts()
    lines = []
    for d in (1.0, 3.0):
        data = encode_image_striped(img, CodecConfig(distance=d, effort=7), n_stripes=n, orig_name="bench", device=dev)
        if not is_striped(data) or len(read_striped(data)[2]) != n:
            raise AssertionError(f"d={d}: not a {n}-section JXTS container")
        out = decode_bytes(data, device=dev)
        naive = np.concatenate([decode_bytes(s, device=dev) for s in read_striped(data)[2]], axis=1)
        epf = [hd.epf for hd in section_headers(data)]
        n_cols = seam_check(out, naive, seams, expect_differs=all(epf), what=f"striped d={d}")
        lines.append((d, data, out, epf, n_cols))
    if not all(lines[1][3]):
        raise AssertionError(f"d=3 sections do not signal EPF ({lines[1][3]}): the seam check has nothing to hold")
    counts = read_counts()
    for d, data, out, _epf, _n in lines:  # the CPU decodes the card's bytes
        lsb = int(np.abs(out.astype(np.int32) - decode_bytes(data, device="cpu")).max())
        if lsb > 1:
            raise AssertionError(f"striped d={d}: card vs CPU pixels differ by {lsb} LSB (> 1)")
    print(
        f"[7 striped] bench image in {n} stripes (seams at {seams}), launches B3 {counts[0]}, B1 {counts[1]}; "
        + "; ".join(
            f"d={d}: {len(data)} B, {psnr(img, out):.4f} dB, sections signal EPF {epf}, {n_cols} columns differ from "
            "the naive paste (all within 8 px of a seam)" for d, data, out, epf, n_cols in lines
        ) + "; card vs CPU pixels <= 1 LSB"
    )

    reset_counts()
    d0 = encode_image_striped(img, CodecConfig(distance=0.0, effort=7), n_stripes=n, device=dev)
    if not np.array_equal(decode_bytes(d0, device=dev), img):
        raise AssertionError("striped d=0 does not round-trip exactly")
    rng = np.random.default_rng(42)
    ui = np.full((h, w // 2, 3), 240, np.uint8)
    for _ in range(96):
        y, x = rng.integers(0, h - 8), rng.integers(0, w // 2 - 44)
        ui[y : y + 6, x : x + int(rng.integers(10, 40))] = [40, 40, 90]
    mixed = np.concatenate([ui, synth_kodak(h, w - w // 2, seed=11)], axis=1)
    md = encode_image_striped(mixed, CodecConfig(distance=1.0, effort=5), n_stripes=4, device=dev)
    modes = [hd.lossless for hd in section_headers(md)]
    mout = decode_bytes(md, device=dev)
    if not (any(modes) and not all(modes)) or mout.shape != mixed.shape or psnr(mixed, mout) <= 30.0:
        raise AssertionError(f"mixed container: modes {modes}, PSNR {psnr(mixed, mout):.2f} dB")
    lsb = int(np.abs(mout.astype(np.int32) - decode_bytes(md, device="cpu")).max())
    if lsb > 1:
        raise AssertionError(f"mixed container: card vs CPU pixels differ by {lsb} LSB (> 1)")
    c2 = read_counts()
    print(
        f"[7 striped] d=0 in {n} stripes exact ({len(d0)} B); mixed UI + photo in 4 stripes: modular sections "
        f"{modes}, {len(md)} B, {psnr(mixed, mout):.4f} dB, card vs CPU <= 1 LSB; launches B3 {c2[0]}, B1 {c2[1]}"
    )
    return tuple(a + b for a, b in zip(counts, c2))


def phase_striped_full(torch, dev, kind, smi, chains, reset_counts, read_counts, height=8192, width=8704, lanes=1024):
    """7b: the striped path above the single-section cap, through
    encode_file and decode_bytes_device; then B3 and B1 on one stripe's
    stream at 1024 lanes against their plain versions. Returns the
    (B3, B1, B2, screen) launches of the main path and the kernels' readings."""
    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import MAX_PIXELS
    from jxl_tpu_torch.codec.decode import decode_bytes_device
    from jxl_tpu_torch.codec.encode import _step_ctx_v8, encode_file, encode_image, entropy_inputs, tokens_from_rgb
    from jxl_tpu_torch.codec.layout import padded_layout
    from jxl_tpu_torch.codec.tiled import default_n_stripes, is_striped, read_striped, stripe_widths
    from jxl_tpu_torch.core.io import write_image

    if height * width <= MAX_PIXELS:
        raise AssertionError(f"{height}x{width} is not above the single-section cap of {MAX_PIXELS} pixels")
    t0 = time.perf_counter()
    big = synth_kodak(height, width, seed=1)
    src = os.path.join(SWEEP_DIR, "big.ppm")
    write_image(src, big)
    make_s = time.perf_counter() - t0
    mp = height * width / 1e6
    n = default_n_stripes(height, width)
    widths = stripe_widths(width, n)
    cfg = CodecConfig(distance=1.0, effort=7)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    size = encode_file(src, os.path.join(SWEEP_DIR, "big.jxt"), cfg, device=dev)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    with open(os.path.join(SWEEP_DIR, "big.jxt"), "rb") as f:
        data = f.read()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = decode_bytes_device(data, device=dev)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    dec_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    ne, n1, n2, ns, nd = read_counts()

    hdrs = section_headers(data)
    if not is_striped(data) or len(data) != size or len(hdrs) != n:
        raise AssertionError(f"encode_file wrote {size} bytes, {len(hdrs)} sections (want JXTS with {n})")
    for hd, ws in zip(hdrs, widths):
        if (hd.height, hd.width) != (height, ws) or hd.height * hd.width > MAX_PIXELS or hd.lanes != lanes or hd.lossless:
            raise AssertionError(f"section {hd.height}x{hd.width}, lanes {hd.lanes}, modular {hd.lossless}")
    relaunches = ne - n
    if ne < n or n1 != 2 * n or n2 != 0:
        raise AssertionError(f"striped launches: B3 {ne}, B1 {n1}, B2 {n2} (want {n} or more, {2 * n}, 0)")
    if tuple(out.shape) != big.shape or out.dtype != torch.uint8:
        raise AssertionError(f"decoded {tuple(out.shape)} {out.dtype}")
    big_t = torch.from_numpy(big).to(dev)
    err = out.to(torch.float32) - big_t.to(torch.float32)
    q_db = float(10.0 * torch.log10(255.0**2 / torch.mean(err.double() ** 2)))
    del err, big_t, out
    if not q_db > 35.0:
        raise AssertionError(f"striped PSNR {q_db:.4f} dB (want > 35)")
    k = n // 2  # one section against encode_image of that stripe alone
    x0 = sum(widths[:k])
    stripe = big[:, x0 : x0 + widths[k]]
    if read_striped(data)[2][k] != encode_image(stripe, CodecConfig(distance=1.0, effort=7, modular=False), device=dev):
        raise AssertionError(f"section {k} differs from encode_image of that stripe alone")
    print(
        f"[7b striped] {kind} ({smi}): {height}x{width} ({mp:.1f} MP > cap {MAX_PIXELS / 1e6:.1f} MP; made and written "
        f"as PPM in {make_s:.1f} s) through encode_file at d=1 e7: JXTS, {n} sections of widths {widths}, each within "
        f"the cap at {lanes} lanes; {size} B, {size * 8 / (height * width):.4f} bpp, PSNR {q_db:.4f} dB; launches B3 {ne} "
        f"({'no relaunch' if relaunches == 0 else str(relaunches) + ' relaunched'}), B1 {n1}; section {k} "
        f"byte-identical to encode_image of its stripe; encode {enc_s:.2f} s ({mp / enc_s:.2f} MP/s, file read "
        f"included), decode {dec_s:.2f} s ({mp / dec_s:.2f} MP/s); peak device memory encode {enc_peak:.2f} GB, "
        f"decode {dec_peak:.2f} GB (one cold run each)"
    )

    # B3 and B1 on that stripe's own stream, at the shape the path gave them
    hs, ws = stripe.shape[:2]
    lay = padded_layout(hs, ws, lanes)
    token, _nb, mant, _params, q_sorted, _vals = tokens_from_rgb(
        torch.from_numpy(np.ascontiguousarray(stripe)).to(dev), 1.0, height=hs, width=ws, effort=7
    )
    tokp, mantp, rows, _freq = entropy_inputs(token, mant, _step_ctx_v8(lay, q_sorted), lay, lanes)
    del token, mant, _vals
    r = hold_stream(
        torch, tokp, mantp, rows, T=lay["T"], t_a=lay["t_a"], lanes=lanes, label="7b stripe", chains=chains,
    )
    print(
        f"[7b kernels] stripe {k} ({hs}x{ws}): {lay['n_tokens']} tokens, lanes {lanes} (G={lanes // 128}), T {lay['T']} (phase A "
        f"{lay['t_a']}), {r['words']} words, {r['mbytes']} mantissa bytes; B3 and B1 (A + B: values, states and pointers of "
        f"both phases) bit-exact vs their plain versions at full length; B1 also returns the encoded values and "
        f"consumes exactly the encoded streams; one plain call each, the compared one, timed by the host clock; "
        f"B3 {r['enc']['ms']:.3f} ms (plain {r['enc_plain_ms']:.0f} ms), B1 {r['dec']['ms']:.3f} ms (plain "
        f"{r['dec_plain_ms']:.0f} ms)"
    )
    torch.cuda.empty_cache()
    return (ne, n1, n2, ns, nd), r


def phase_mesh(torch, dev, img, reset_counts, read_counts):
    """8: the mesh paths on slots of the one card, each against its
    sequential form. Returns the (B3, B1, B2, screen) launches of the mesh calls."""
    from dataclasses import replace

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import decode_stream_planes
    from jxl_tpu_torch.codec.encode import _modular_candidate, encode_image, encode_image_grid
    from jxl_tpu_torch.codec.tiled import encode_image_striped, encode_image_striped_sharded
    from jxl_tpu_torch.core.io import read_png_rgb8
    from jxl_tpu_torch.distributed.mesh import make_mesh
    from jxl_tpu_torch.distributed.sharded import encode_grid_sharded, sharded_epf
    from jxl_tpu_torch.transforms.epf import epf_apply

    synth_dir = os.path.join(REPO, "test_images", "synth")
    names = sorted(os.listdir(synth_dir))
    imgs = [read_png_rgb8(os.path.join(synth_dir, nm)) for nm in names[:4]]
    cfg = CodecConfig(effort=7)
    reset_counts()
    t0 = time.perf_counter()
    grids = encode_grid_sharded(imgs, cfg, RUST_DISTANCES, mesh=make_mesh([dev] * 2, data=2), orig_names=names[:4])
    mesh_s = time.perf_counter() - t0
    shd = encode_image_striped_sharded(img, CodecConfig(distance=1.0, effort=7), make_mesh([dev] * 4), orig_name="bench")
    counts = read_counts()
    if counts[0] < 4 * len(RUST_DISTANCES) + 4:
        raise AssertionError(f"mesh launches: B3 {counts[0]} (want >= {4 * len(RUST_DISTANCES) + 4})")
    t0 = time.perf_counter()
    for im, nm, row in zip(imgs, names, grids):
        if row != encode_image_grid(im, replace(cfg, modular=False), RUST_DISTANCES, nm, device=dev):
            raise AssertionError(f"{nm}: encode_grid_sharded differs from encode_image_grid")
    seq_s = time.perf_counter() - t0
    if shd != encode_image_striped(img, CodecConfig(distance=1.0, effort=7), 4, "bench", device=dev):
        raise AssertionError("encode_image_striped_sharded differs from encode_image_striped")
    planes, eff_mul = decode_stream_planes(
        read_container(encode_image(img, CodecConfig(distance=3.0, effort=7), device=dev)), device=dev
    )
    if not torch.equal(sharded_epf(planes, eff_mul, 3.0, make_mesh([dev] * 4, space=4)), epf_apply(planes, eff_mul, 3.0)):
        raise AssertionError("sharded_epf differs from epf_apply")
    print(
        f"[8 mesh] encode_grid_sharded, 4 images x {len(RUST_DISTANCES)} distances on data=2 slots of {dev}: "
        f"byte-identical to encode_image_grid under modular=False ({mesh_s:.2f} s against {seq_s:.2f} s sequential, "
        f"one run each); encode_image_striped_sharded (4 stripes on data=4) equals encode_image_striped; sharded_epf "
        f"on space=4 equals epf_apply exactly on {tuple(planes.shape)}; launches B3 {counts[0]}"
    )

    pick = [nm for nm in names if not _modular_candidate(read_png_rgb8(os.path.join(synth_dir, nm)), 1)][:2]
    img_dir = os.path.join(SWEEP_DIR, "mesh_images")
    os.makedirs(os.path.join(img_dir, "pair"))
    for nm in pick:
        shutil.copy(os.path.join(synth_dir, nm), os.path.join(img_dir, "pair", nm))
    base = ["bench", "--device", str(dev), "--test-image-dir", img_dir, "--distances", "0.5", "1", "3", "--efforts", "7"]
    reset_counts()
    walls, texts = [], []
    for tag, extra in (("mesh", ["--mesh", "data=2"]), ("single", [])):
        out_dir = os.path.join(SWEEP_DIR, f"mesh_{tag}")
        walls.append(run_bench_cli(base + ["--benchmark-dir", out_dir] + extra, os.path.join(SWEEP_DIR, f"mesh_{tag}.log")))
        with open(os.path.join(out_dir, "0", "pair", "BASELINE", "results", "comparisons.csv")) as f:
            texts.append(f.read())
    c2 = read_counts()
    if texts[0] != texts[1] or len(texts[0].splitlines()) != 7:
        raise AssertionError("bench --mesh data=2: comparisons.csv differs from the single-device run's")
    print(
        f"[8 mesh] bench --mesh data=2 on {pick} x 3 distances: comparisons.csv equal to the single-device run's in "
        f"every column (6 rows); wall {walls[0]:.2f} s against {walls[1]:.2f} s; launches B3 {c2[0]}, B2 {c2[2]}"
    )
    return tuple(a + b for a, b in zip(counts, c2))


def phase_serve(torch, dev, kind, smi, img):
    """9: the persistent server on the card against cold one-shot processes:
    equal files, process walls of both. Every process started here has
    ended, or is killed, before this returns."""
    from jxl_tpu_torch.cli.server import try_forward
    from jxl_tpu_torch.core.io import write_image

    work = os.path.join(SWEEP_DIR, "serve")
    os.makedirs(work)
    # a unix socket's path holds ~100 bytes: name it relative to where each process runs
    sock = os.path.relpath(os.path.join(work, "jxl.sock"), REPO)  # the server and the clients run from REPO
    sock_here = os.path.relpath(os.path.join(work, "jxl.sock"))
    src = os.path.join(work, "bench.png")
    write_image(src, img)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JXL_TPU_")}
    cli = [sys.executable, "-m", "jxl_tpu_torch"]

    def client(tag: str, extra_env: dict) -> tuple:
        """encode then decode as two fresh processes; (encode s, decode s, jxt bytes, png bytes)."""
        jxt, png = os.path.join(work, f"{tag}.jxt"), os.path.join(work, f"{tag}.png")
        walls = []
        for argv in (["encode", src, jxt, "--device", str(dev)], ["decode", jxt, png, "--device", str(dev)]):
            t0 = time.perf_counter()
            run = subprocess.run(cli + argv, cwd=REPO, env={**env, **extra_env}, capture_output=True, text=True, timeout=300)
            walls.append(time.perf_counter() - t0)
            if run.returncode != 0:
                raise AssertionError(f"{tag} {argv[0]} failed: {run.stdout[-500:]}{run.stderr[-2000:]}")
        with open(jxt, "rb") as f1, open(png, "rb") as f2:
            return walls[0], walls[1], f1.read(), f2.read()

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cli + ["serve", "--device", str(dev), "--socket", sock], cwd=REPO, env=env, stdout=subprocess.PIPE, text=True
    )
    try:
        ready = proc.stdout.readline()
        start_s = time.perf_counter() - t0
        if not ready.startswith("[serve] ready on") or not os.path.exists(sock_here):
            raise AssertionError(f"server did not come up: {ready!r}")
        pong = try_forward({"cmd": "ping"}, socket_path=sock_here)
        if pong != {"ok": True, "msg": "pong", "device": str(dev)}:
            raise AssertionError(f"ping: {pong}")
        fwd = [client(f"fwd{i}", {"JXL_TPU_TORCH_SOCKET": sock}) for i in range(3)]
        cold = [client(f"cold{i}", {"JXL_TPU_TORCH_NO_SERVER": "1"}) for i in range(2)]
        for r in fwd + cold[1:]:
            if r[2] != cold[0][2] or r[3] != cold[0][3]:
                raise AssertionError("forwarded and local invocations wrote different files")
        bye = try_forward({"cmd": "shutdown"}, socket_path=sock_here)
        rc = proc.wait(timeout=60)
        if not (bye and bye.get("ok")) or rc != 0 or os.path.exists(sock_here):
            raise AssertionError(f"shutdown: reply {bye}, exit code {rc}, socket left: {os.path.exists(sock_here)}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(
        f"[9 serve] {kind} ({smi}): server ready in {start_s:.2f} s (torch import, CUDA context, kernels loaded); "
        f"bench image {len(cold[0][2])} B; process wall, encode / decode: cold local "
        + ", ".join(f"{e:.2f} / {d:.2f} s" for e, d, _j, _p in cold) + "; forwarded "
        + ", ".join(f"{e:.2f} / {d:.2f} s" for e, d, _j, _p in fwd)
        + " (the first forwarded pair carries the server's first-use costs); files equal; socket removed at shutdown"
    )


def phase_standalone(torch, dev, kind, smi, reset_counts, read_counts):
    """10: the standalone interleaved rANS coder and the bit packer at the
    bench image's stream size, on the card, against the port on the CPU and
    the native C++ core, bit for bit; the card decodes its own stream. No
    kernel may launch. Returns the (B3, B1, B2, screen) launches of the phase."""
    from jxl_tpu_torch.entropy import rans as tr
    from jxl_tpu_torch.entropy import tokens as tt
    from jxl_tpu_torch.native import bindings

    t_phase = time.perf_counter()
    n_ctx, alphabet, lanes, T = 765, tt.ALPHABET, 256, 4731
    n = lanes * T  # 1,211,136 tokens, as the bench image's d=1 stream
    rng = np.random.default_rng(10)
    ctx = rng.integers(0, n_ctx, n).astype(np.int32)
    p = 0.15 + 0.7 * ctx / n_ctx  # a geometric skew of its own per context
    tok = np.minimum(rng.geometric(p) - 1, alphabet - 1).astype(np.int32)
    counts = np.zeros((n_ctx, alphabet), np.int64)
    np.add.at(counts, (ctx, tok), 1)
    freq, cum = tr.quantize_histograms(counts)

    def timed(fn, sync):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t_dev = [torch.from_numpy(a.astype(np.int64)).to(dev) for a in (tok, ctx, freq, cum)]
    reset_counts()
    (w_c, nw_c, st_c), enc_card = timed(lambda: tr.rans_encode(*t_dev, lanes=lanes), True)
    back, dec_card = timed(lambda: tr.rans_decode(w_c, st_c, *t_dev[1:], n, lanes), True)
    nbits = torch.from_numpy(rng.integers(0, tt.MAX_NBITS + 1, n).astype(np.int32))
    mant = torch.from_numpy(rng.integers(0, 1 << 24, n)) & ((1 << nbits.long()) - 1)
    cap = tt.bit_capacity_words(n)
    nbits_c, mant_c = nbits.to(dev), mant.to(dev)
    (pw_c, _bits), pack_card = timed(lambda: tt.pack_bits(nbits_c, mant_c, cap), True)
    unpacked, unpack_card = timed(lambda: tt.unpack_bits(nbits_c, pw_c), True)
    counts_run = read_counts()
    if counts_run != (0, 0, 0, 0, 0):
        raise AssertionError(f"the standalone coder launched kernels: B3, B1, B2, screen, D1 = {counts_run}")

    (w_h, nw_h, st_h), enc_cpu = timed(lambda: tr.rans_encode(tok, ctx, freq, cum, lanes, device="cpu"), False)
    back_h, dec_cpu = timed(lambda: tr.rans_decode(w_h, st_h, ctx, freq, cum, n, lanes, device="cpu"), False)
    (pw_h, _b), pack_cpu = timed(lambda: tt.pack_bits(nbits, mant, cap), False)
    bindings.build()
    (w_n, nw_n, st_n), enc_nat = timed(lambda: bindings.rans_encode_native(tok, ctx, freq, cum, lanes), False)
    back_n, dec_nat = timed(
        lambda: bindings.rans_decode_native(w_c.cpu().numpy(), int(nw_c), st_c.cpu().numpy(), ctx, freq, cum, n, lanes),
        False,
    )
    pw_n, pack_nat = timed(lambda: bindings.pack_bits_native(nbits, mant, cap), False)

    w_c, st_c = w_c.cpu(), st_c.cpu()
    checks = {
        "words card = CPU": torch.equal(w_c, w_h), "words card = native": np.array_equal(w_c.numpy(), w_n),
        "n_words": int(nw_c) == int(nw_h) == nw_n,
        "states card = CPU = native": torch.equal(st_c, st_h) and np.array_equal(st_c.numpy(), st_n),
        "stream bytes": tr.serialize_streams(w_c, nw_c) == tr.serialize_streams(w_n, nw_n),
        "card decode": np.array_equal(back.cpu().numpy(), tok), "CPU decode": np.array_equal(back_h.numpy(), tok),
        "native decode of the card's stream": np.array_equal(back_n, tok),
        "bit words card = CPU = native": torch.equal(pw_c.cpu(), pw_h) and np.array_equal(pw_h.numpy(), pw_n.astype(np.int64)),
        "bit unpack": torch.equal(unpacked.cpu(), mant),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"standalone coder: {bad} differ")
    print(
        f"[10 standalone] {kind} ({smi}): {n} tokens, {n_ctx} contexts, alphabet {alphabet}, lanes {lanes}, "
        f"T {T}: {int(nw_c)} words ({len(tr.serialize_streams(w_c, nw_c))} B); card = CPU = native bit for bit "
        f"(words, states, stream bytes), every decode returns the tokens, no kernel launched; host wall, encode / "
        f"decode: card {enc_card:.3f} / {dec_card:.3f} s, CPU {enc_cpu:.3f} / {dec_cpu:.3f} s, native "
        f"{enc_nat:.4f} / {dec_nat:.4f} s; pack_bits of {int(nbits.sum())} bits: card {1e3 * pack_card:.1f} ms "
        f"(unpack {1e3 * unpack_card:.1f} ms; first calls, inputs on the card), CPU {1e3 * pack_cpu:.1f} ms, "
        f"native {1e3 * pack_nat:.1f} ms; the phase took {time.perf_counter() - t_phase:.1f} s"
    )
    return counts_run


def phase_headline(torch, dev, kind, smi, img, reset_counts, read_counts):
    """11: the headline benchmark (what bench_torch.py prints) at reps = 2,
    held to the quality anchor and to B1 / B2 / B3 launches; the host syncs
    of one e7 encode; traced e8 / d = 0 encodes, the d = 0 decode and a
    sweep row's battery.
    Returns the (B3, B1, B2, screen) launches of the phase."""
    from jxl_tpu_torch.bench.headline import headline, traced
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes_device, decode_bytes_grid_stacked
    from jxl_tpu_torch.codec.encode import encode_image, encode_image_grid
    from jxl_tpu_torch.metrics.battery import metric_battery_grid_async

    t_phase = time.perf_counter()
    reset_counts()
    res = headline(img, device=dev, reps=2)
    print(f"[11 headline] {json.dumps(res)}")
    print(f"[11 trace] {kind} ({smi}): {json.dumps(res['trace'])}")
    if abs(res["psnr_db"] - ANCHOR_PSNR_DB) > PSNR_TOL_DB or abs(res["bpp"] - ANCHOR_BPP) > BPP_TOL_REL * ANCHOR_BPP:
        raise AssertionError(f"headline {res['psnr_db']} dB / {res['bpp']} bpp misses the anchor")
    if min(res["launches"].values()) < 1:
        raise AssertionError(f"headline launches {res['launches']}: B1, B2 and B3 must each run")
    for name, t in res["trace"].items():
        if not (0.0 <= t["idle_share"] <= 1.0 and t["busy_ms"] > 0 and t["kernels"] > 0):
            raise AssertionError(f"trace {name} out of range: {t}")
    roof = res["roofline"]
    if (roof["encode_device_ms"], roof["decode_device_ms"]) != (
        res["trace"]["encode_row"]["busy_ms"], res["trace"]["decode_row"]["busy_ms"],
    ):
        raise AssertionError(f"device ms {roof} are not the traced rows' busy time")

    cfg = CodecConfig(distance=1.0, effort=7)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            encode_image(img, cfg, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
        for w in caught
        if "called a synchronizing CUDA operation" in str(w.message)
    )
    print(
        f"[11 syncs] one e7 encode of the bench image: {sum(syncs.values())} host synchronisations "
        f"(set_sync_debug_mode warnings) at {len(syncs)} source lines; most: "
        + ", ".join(f"{k} x{v}" for k, v in syncs.most_common(8))
    )
    if not syncs:
        raise AssertionError("no synchronisation warning recorded: set_sync_debug_mode did not report")

    cfg0 = CodecConfig(distance=0.0)
    data0 = encode_image(img, cfg0, device=dev)
    sweep_row = decode_bytes_grid_stacked(encode_image_grid(img, cfg, RUST_DISTANCES, device=dev), device=dev)
    rows = {
        "encode e8": traced(lambda: encode_image(img, CodecConfig(distance=1.0, effort=8), device=dev), dev, 1)[1],
        "encode d=0": traced(lambda: encode_image(img, cfg0, device=dev), dev, 1)[1],
        "decode d=0": traced(lambda: decode_bytes_device(data0, device=dev), dev, 1)[1],
        "battery, sweep row": traced(
            lambda: metric_battery_grid_async(img, sweep_row, device=dev)(), dev, len(RUST_DISTANCES)
        )[1],
    }
    for name, t in rows.items():
        if not (0.0 <= t["idle_share"] <= 1.0 and t["busy_ms"] > 0):
            raise AssertionError(f"trace {name} out of range: {t}")
    print(f"[11 trace] {kind} ({smi}): " + "; ".join(f"{k}: {json.dumps(v)}" for k, v in rows.items()))
    counts = read_counts()
    print(f"[11 headline] launches B3 {counts[0]}, B1 {counts[1]}, B2 {counts[2]}, screen {counts[3]}, D1 {counts[4]}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def tool_lines(tag: str, fn, *args, **kw):
    """Run a tool's function, printing what it prints behind `[12 tag]`;
    returns its result."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    for line in buf.getvalue().splitlines():
        print(f"[12 {tag}] {line}")
    return out


def phase_tools(torch, dev, kind, smi, img, reset_counts, read_counts):
    """12: the measurement tools on the card (see the module docstring).
    Returns the (B3, B1, B2, screen) launches of the phase's own process."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.encode import encode_image
    from jxl_tpu_torch.core.io import write_image
    from jxl_tpu_torch.tools import batch_scaling, bit_breakdown, epf_ab, profile_stages, rd_point
    from jxl_tpu_torch.tools.make_test_images import synth_photo

    t_phase = time.perf_counter()
    reset_counts()
    h, w = img.shape[:2]
    data = encode_image(img, CodecConfig(distance=1.0, effort=7), device=dev)

    res = profile_stages.profile(img, dev)
    print(f"[12 stages] {kind} ({smi}): median of 5 warm runs (host clock, synchronised); busy ms and kernels of one traced run")
    tool_lines("stages", profile_stages.print_table, res, dev, h, w)
    if res["bytes"] != data:
        raise AssertionError("profile_stages' full-encode container differs from encode_image's")
    for name, t in res["stages"].items():
        if not (t["ms"] > 0 and t["busy_ms"] > 0 and t["kernels"] > 0):
            raise AssertionError(f"stage {name}: {t}")

    rows = tool_lines("batch", batch_scaling.scaling_rows, img, dev)
    print(f"[12 batch] {kind} ({smi}): " + "; ".join(
        f"B={b}: enc {e:.2f} / dec {d:.2f} / combined {c:.2f} MP/s" for b, e, d, c in rows
    ))
    if [r[0] for r in rows] != list(batch_scaling.BATCHES) or not all(v > 0 for r in rows for v in r[1:]):
        raise AssertionError(f"batch_scaling rows {rows}")

    dists = list(rd_point.DISTANCES)
    pts = rd_point.rd_points({"bench": img, "synth0": synth_photo(h, w, seed=100)}, dists, 7, dev)
    print(f"[12 rd_point] {json.dumps(pts)}")
    _d, bpp, p = pts["bench"][dists.index(1.0)]
    if abs(p - ANCHOR_PSNR_DB) > PSNR_TOL_DB or abs(bpp - ANCHOR_BPP) > BPP_TOL_REL * ANCHOR_BPP:
        raise AssertionError(f"rd_point bench d=1: {p} dB / {bpp} bpp misses the anchor")

    bd = bit_breakdown.breakdown(img, 1.0, 7, dev)
    tool_lines("bit_breakdown", bit_breakdown.print_breakdown, bd, h, w, 1.0, 7)
    sec, pay = bit_breakdown.payload_bits(bd)
    if bd["data"] != data or abs(sec / pay - 1) > 1e-3:
        raise AssertionError(f"bit_breakdown: sections {sec / 8:.1f} B against payload {pay / 8:.1f} B")

    epf = tool_lines("epf_ab", epf_ab.epf_rows, {"bench": img}, [1.0, 4.0, 8.0], dev)
    if not all(np.isfinite(r[3]) and np.isfinite(r[4]) and r[2] > 0 for r in epf):
        raise AssertionError(f"epf_ab rows {epf}")
    counts = read_counts()

    tdir = os.path.join(SWEEP_DIR, "tools")
    os.makedirs(tdir, exist_ok=True)
    png, out = os.path.join(tdir, "bench.png"), os.path.join(tdir, "bench.jxt")
    write_image(png, img)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "jxl_tpu_torch.tools.profile_startup", "--encode", png, "--device", "cuda:0", "--out", out],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"profile_startup failed:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    marks = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[12 startup] {json.dumps(marks)} (process wall {time.perf_counter() - t0:.2f} s)")
    with open(out, "rb") as f:
        if f.read() != data:
            raise AssertionError("profile_startup's container differs from encode_image's")
    if marks["device"] != smi or not all(v > 0 for v in marks["phase_s"].values()):
        raise AssertionError(f"profile_startup marks {marks}")
    print(f"[12 tools] launches B3 {counts[0]}, B1 {counts[1]}, B2 {counts[2]}, screen {counts[3]}, D1 {counts[4]} (this process); "
          f"the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def phase_screen(torch, dev, smi) -> dict:
    """Phase 3d: the pre-screen kernel against its plain version, timed at
    4032x3024, 4097x4096 and 768x512; beside it the plain version on the
    card, as `screen_count` would run it there without the kernel: wall,
    kernel time, kernels and the memory it allocates. Returns the photo's
    timings at 4032x3024 for the kernels JSON."""
    from jxl_tpu_torch.bench.headline import PEAK_BW, traced
    from jxl_tpu_torch.codec.screen import _launch, screen_count, screen_plain, screen_stride
    from jxl_tpu_torch.tools.make_test_images import synth_graphics, synth_photo

    def extra_bytes(fn) -> int:
        """Device bytes fn allocates above what is held when it starts."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - held

    photo = None
    for name, (hh, ww), make in (
        ("photo", (3024, 4032), synth_photo), ("graphics", (3024, 4032), synth_graphics),
        ("graphics", (4097, 4096), synth_graphics), ("photo", (512, 768), synth_photo),
    ):
        frame = torch.from_numpy(np.ascontiguousarray(make(hh, ww, 0)))
        on_card = frame.to(dev)
        s = screen_stride(hh, ww)
        n0 = screen_count.launches
        count, n = screen_count(on_card)
        if screen_count.launches != n0 + 1:
            raise AssertionError(f"screen_count launched {screen_count.launches - n0} kernels, expected 1")
        t0 = time.perf_counter()
        plain = screen_plain(frame, s)
        plain_ms = 1e3 * (time.perf_counter() - t0)
        plain_card = screen_plain(on_card, s)
        if not count == plain == plain_card:
            raise AssertionError(f"screen {name} {hh}x{ww}: kernel {count}, plain {plain} (CPU), {plain_card} (card)")
        acc = torch.zeros(1, dtype=torch.int64, device=dev)
        ms = cuda_ms(torch, lambda: _launch(on_card, s, acc), 20)
        if int(acc.item()) != 21 * count:
            raise AssertionError(f"screen {name}: 21 launches added {int(acc.item())}, expected {21 * count}")
        whole_ms = cuda_ms(torch, lambda: screen_count(on_card), 20)
        plain_card_ms = cuda_ms(torch, lambda: screen_plain(on_card, s), 20)
        _c, kt = traced(lambda: screen_count(on_card), dev, 1)
        _c, pt = traced(lambda: screen_plain(on_card, s), dev, 1)
        k_mb, p_mb = (extra_bytes(f) / 1e6 for f in (lambda: screen_count(on_card), lambda: screen_plain(on_card, s)))
        nbytes = 3 * -(-hh // s) * ww  # every s-th row, read whole (a pixel every 3 s bytes)
        bound_ms = 1e3 * nbytes / PEAK_BW
        print(
            f"[3d screen] {name} {hh}x{ww} stride {s}: {count} of {n} positions ({count / n:.4f}), kernel = plain "
            f"(card and CPU); kernel {1e3 * ms:.2f} us (mean of 20 launches), screen_count with its fill and "
            f"read-back {1e3 * whole_ms:.1f} us; bound {1e3 * bound_ms:.2f} us ({nbytes / 1e6:.2f} MB at "
            f"{PEAK_BW / 1e12:.2f} TB/s, {100 * bound_ms / ms:.1f}%); plain on the host {plain_ms:.1f} ms ({smi})"
        )
        print(
            f"[3d screen vs plain on the card] {name} {hh}x{ww}: screen_count wall {kt['wall_ms']:.3f} ms "
            f"(busy {1e3 * kt['busy_ms']:.1f} us, {kt['kernels']} kernels, {k_mb:.2f} MB allocated); screen_plain "
            f"on the card wall {pt['wall_ms']:.3f} ms (busy {1e3 * pt['busy_ms']:.1f} us, {pt['kernels']} kernels, "
            f"{p_mb:.2f} MB allocated; {1e3 * plain_card_ms:.1f} us a call, CUDA-event mean of 20)"
        )
        if photo is None:
            photo = dict(ms=ms, bound_ms=bound_ms, whole_ms=whole_ms, plain_ms=plain_ms)
    return photo


def dct_views_12mp(torch, dev) -> dict:
    """The views the encoder's 8x8, 4x4 and 64x64 DCT calls (`search_acs`)
    pass at 12 MP (4032x3024), on the card: the 8x8 blocks of the planes,
    their 4x4 quadrants, and the 64x64 tiles of the planes' aligned part."""
    g = torch.Generator(device=dev).manual_seed(17)
    planes = torch.randn(3, 3024, 4032, generator=g, device=dev) * 64
    blocks = planes.reshape(3, 378, 8, 504, 8).permute(0, 1, 3, 2, 4)
    lead = blocks.shape[:-2]
    return {
        "8x8": blocks,
        "4x4": blocks.reshape(*lead, 2, 4, 2, 4).permute(0, 1, 2, 3, 5, 4, 6),
        "64x64": planes[:, :3008].reshape(3, 47, 64, 63, 64).permute(0, 1, 3, 2, 4),
    }


def phase_dct(torch, dev, smi) -> dict:
    """Phase 3e: the DCT kernel D1 at the 12 MP views of the encoder's
    8x8, 4x4 and 64x64 calls, forward and inverse: one launch a call, the
    same bits from two launches, its distance from the cuBLAS path's result,
    its CUDA-event mean of 20 launches beside its bound (one read and one
    write of the samples at PEAK_BW, or 2 (n + m) FLOPs a sample at
    PEAK_FLOPS, the larger) and beside torch.matmul on the same view (the
    bases already on the card). Returns the 8x8 forward timing."""
    from jxl_tpu_torch.bench.headline import PEAK_BW, PEAK_FLOPS
    from jxl_tpu_torch.transforms.dct import dct2d, dct2d_cuda, dct_matrix, idct2d

    first = None
    for name, x in dct_views_12mp(torch, dev).items():
        n, m = x.shape[-2:]
        dn, dm = dct_matrix(n, dev), dct_matrix(m, dev)
        for inverse, fn in ((False, dct2d), (True, idct2d)):
            gemm = (lambda: torch.matmul(torch.matmul(dn.T, x), dm)) if inverse else (
                lambda: torch.matmul(torch.matmul(dn, x), dm.T))
            n0 = dct2d_cuda.launches
            a, b = fn(x), fn(x)
            torch.cuda.synchronize()
            want = 2 * (2 if max(n, m) > 64 else 1)
            if dct2d_cuda.launches - n0 != want:
                raise AssertionError(f"D1 {name}: {dct2d_cuda.launches - n0} launches for 2 calls, expected {want}")
            if not torch.equal(a, b):
                raise AssertionError(f"D1 {name}: two launches differ")
            ref = gemm()
            rel = float((a - ref).abs().max() / ref.abs().max())
            if rel > 1e-5:
                raise AssertionError(f"D1 {name}: {rel:.3g} of max|Y| from the cuBLAS path")
            ms = cuda_ms(torch, lambda: fn(x), 20)
            lib_ms = cuda_ms(torch, gemm, 20)
            nbytes = 2 * 4 * x.numel()
            bytes_ms, flops_ms = 1e3 * nbytes / PEAK_BW, 1e3 * 2 * (n + m) * x.numel() / PEAK_FLOPS
            bound_ms = max(bytes_ms, flops_ms)
            kind = "idct" if inverse else "dct"
            print(
                f"[3e D1] {kind} {name} {tuple(x.shape)} (strides {x.stride()}): same bits twice, "
                f"{rel:.2e} of max|Y| from cuBLAS; kernel {1e3 * ms:.1f} us (mean of 20 launches), bound "
                f"{1e3 * bound_ms:.1f} us ({'bytes' if bytes_ms >= flops_ms else 'FLOPs'}: {nbytes / 1e6:.1f} MB "
                f"-> {1e3 * bytes_ms:.1f} us, {2 * (n + m) * x.numel() / 1e9:.2f} GFLOP -> {1e3 * flops_ms:.1f} us; "
                f"{100 * bound_ms / ms:.1f}%); torch.matmul on the view {1e3 * lib_ms:.1f} us ({smi})"
            )
            if first is None:
                first = dict(ms=ms, bound_ms=bound_ms, library_ms=lib_ms, max_rel_err=rel)
    return first


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # ---- 1. card
    from jxl_tpu_torch.bench.headline import smi_line, synth_kodak

    dev = torch.device("cuda:0")
    smi = smi_line(dev)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 card] {kind} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    from jxl_tpu_torch.codec.config import CodecConfig, Strategy
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import (
        _padded_values,
        _scan_one,
        _unpad,
        decode_bytes,
        decode_bytes_device,
        decode_bytes_grid_stacked,
        decode_values,
        decode_values_grid,
    )
    from jxl_tpu_torch.codec.encode import (
        _modular_async,
        _modular_grid_async,
        _step_ctx_v8,
        encode_image,
        encode_image_grid,
        encoder_knobs,
        entropy_inputs,
        pick_lanes,
        tokens_from_rgb,
    )
    from jxl_tpu_torch.codec.layout import lossless_layout, padded_layout, token_layout
    from jxl_tpu_torch.codec.lossless import ll_step_ctx, lossless_tokens, modular_steps
    from jxl_tpu_torch.codec import decode as decode_mod
    from jxl_tpu_torch.codec.screen import screen_count
    from jxl_tpu_torch.core.device import resolve_device
    from jxl_tpu_torch.core.io import read_png_rgb8
    from jxl_tpu_torch.cuda_build import BUILD_LOGS, build
    from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_batched_cuda, decode_grouped_cuda
    from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda
    from jxl_tpu_torch.entropy.grouped import decode_grouped_batched
    from jxl_tpu_torch.entropy import kernel_bounds
    from jxl_tpu_torch.strategy import acs as acs_mod
    from jxl_tpu_torch.transforms.dct import dct2d_cuda

    # every dct2d / idct2d call of the codec (the names strategy.acs and codec.decode call), counted
    # apart from the kernel's own counter: a CUDA call must take D1, once (twice for a side above 64)
    dct_calls = Counter()

    def counted(fn):
        def call(x):
            if x.is_cuda and x.numel():
                dct_calls["calls"] += 1
                dct_calls["launches"] += 2 if max(x.shape[-2:]) > 64 else 1
            return fn(x)

        return call

    for mod, name in ((acs_mod, "dct2d"), (acs_mod, "idct2d"), (decode_mod, "idct2d")):
        setattr(mod, name, counted(getattr(mod, name)))

    def reset_counts():
        encode_grouped_cuda.launches = 0
        decode_grouped_cuda.launches = 0
        decode_grouped_batched_cuda.launches = 0
        screen_count.launches = 0
        dct2d_cuda.launches = 0
        dct_calls.clear()

    def read_counts():
        """(B3, B1, B2, screen, D1) launches since reset_counts(), after the card is done;
        raises unless D1's launches are those the codec's DCT calls since then should take."""
        torch.cuda.synchronize()
        if dct2d_cuda.launches != dct_calls["launches"]:
            raise AssertionError(
                f"D1 launched {dct2d_cuda.launches} times for {dct_calls['calls']} DCT calls on the card "
                f"(want {dct_calls['launches']})"
            )
        return (
            encode_grouped_cuda.launches, decode_grouped_cuda.launches, decode_grouped_batched_cuda.launches,
            screen_count.launches, dct2d_cuda.launches,
        )

    resolve_device(dev)

    # ---- 2. build (one nvcc per source, all started together)
    t0 = time.perf_counter()
    sources = ("rans_dec", "rans_enc", "screen", "dct", "chain_probe")
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        list(ex.map(build, sources))
    build_s = time.perf_counter() - t0
    print(f"[2 build] {' + '.join(sources)} built in {build_s:.2f} s")
    for name, log in BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 build] {name}: {line.strip()}")
    chains = kernel_bounds.measure_chain_cycles(dev)
    print(
        f"[2 chains] SM cycles per link, one warp, {kernel_bounds.PROBE_LINKS} links (csrc/chain_probe.cu): "
        + ", ".join(f"{k} {v:.2f}" for k, v in chains.items())
    )
    if not all(0 < v < 1e4 for v in chains.values()):
        raise AssertionError(f"chain probe readings out of range: {chains}")

    # ---- 3. kernels vs plain at the bench shapes
    img = synth_kodak()  # the bench image (bench.py:synth_kodak, 512x768, seed 0)
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

    b3 = hold_stream(
        torch, tokp, mantp, rows, T=T, t_a=t_a, lanes=lanes, label="3", chains=chains,
    )
    enc_err, enc_ms, enc_plain_ms = b3["enc_err"], b3["enc"]["ms"], b3["enc_plain_ms"]
    dec_err, dec_ms, dec_plain_ms = b3["dec_err"], b3["dec"]["ms"], b3["dec_plain_ms"]
    print(
        f"[3 encode kernel] bit-exact vs plain; {b3['words']} words, {b3['mbytes']} mantissa bytes; "
        f"kernel {enc_ms:.3f} ms, plain {enc_plain_ms:.1f} ms"
    )
    print(
        f"[3 decode kernel] both phases bit-exact vs plain (values, states, pointers); "
        f"kernel {dec_ms:.3f} ms, plain {dec_plain_ms:.1f} ms (A + B)"
    )

    # ---- 3b. batched decode kernel (B2) vs plain at the bench shape
    cfg = CodecConfig(distance=1.0, effort=7)
    rows_of = {10: RUST_DISTANCES, GRID_BATCH: tuple(float(d) for d in np.linspace(0.5, 14.0, GRID_BATCH))}
    b2_ms, b2_t, b2_err, b2_plain_ms = {}, {}, 0, None
    for B, dists in rows_of.items():
        streams = [read_container(b) for b in encode_image_grid(img, cfg, dists, device=dev)]
        calls, errs = [], []

        def probe(*args, T, lanes):
            """B2 as the grid decode calls it, held against its plain version."""
            k = decode_grouped_batched_cuda(*args, T=T, lanes=lanes)
            errs.append(max_abs_diff(zip(k, decode_grouped_batched(*args, T=T, lanes=lanes))))
            calls.append((args, T, lanes, k))
            return k

        grid_vals = _unpad(_padded_values(streams, dev, probe), lay)
        torch.cuda.synchronize()
        b2_err = max(b2_err, *errs)
        if b2_err != 0:
            raise AssertionError(f"batched decode kernel differs from its plain version at B={B} (max |d| {b2_err})")
        counts = torch.from_numpy(np.stack([np.concatenate([s.wcounts, s.mcounts]) for s in streams]).astype(np.int32))
        end_ptrs = calls[-1][3][2].cpu().reshape(2, B, G).permute(1, 0, 2).reshape(B, 2 * G)
        if not torch.equal(end_ptrs, counts):
            raise AssertionError(f"batched decode kernel did not consume exactly the encoded streams at B={B}")
        for i, s in enumerate(streams):
            if not torch.equal(grid_vals[i], decode_values(s, dev)):
                raise AssertionError(f"stream {i} of B={B}: batched decode differs from the single-stream kernel")

        def run_phases(fn):
            for args, T, lanes, _k in calls:
                fn(*args, T=T, lanes=lanes)

        def b2_launch(nb=B):
            """B2 on the first nb streams."""
            def fn(words, mant, states, rows_, ptrs, *, T, lanes):
                return decode_grouped_batched_cuda(
                    words[: nb * G].contiguous(), mant[: nb * G].contiguous(), states[:nb].contiguous(),
                    rows_[:, :nb].contiguous(), ptrs[:, : nb * G].contiguous(), T=T, lanes=lanes,
                )
            return fn

        def b2_bytes(nb=B):
            return sum(
                kernel_bounds.decode_bytes(T_, lanes_, *(int(v) for v in (k[2] - a[4]).reshape(2, B, G)[:, :nb].sum(dim=(1, 2))), B=nb)
                for a, T_, lanes_, k in calls
            )

        b2_t[B] = kernel_time(
            torch, lambda: run_phases(b2_launch()), T=T, nbytes=b2_bytes(), step_cycles=chains["decode_step"]
        )
        b2_ms[B] = b2_t[B]["ms"]
        print(f"[3b B2 B={B}] (A + B) {bound_text(b2_t[B])}")
        if B == GRID_BATCH:
            scale = [(nb, cuda_ms(torch, lambda: run_phases(b2_launch(nb)), 20)) for nb in (1, 4, 10, 16, 32)]
            print(
                "[3b B2 scaling] first nb streams of the 32-point row, A + B: "
                + ", ".join(f"B={nb} {ms:.3f} ms" for nb, ms in scale)
            )
        if B == 10:
            # B1 alone on the row's densest stream (d=0.5, the most words and
            # mantissa bytes per step): a batch runs at its slowest chain's pace
            dense = []

            def probe_b1(*args, T, lanes):
                dense.append((args, T, lanes))
                return _scan_one(*args, T=T, lanes=lanes)

            _padded_values(streams[:1], dev, probe_b1)
            b1_dense_ms = cuda_ms(torch, lambda: [_scan_one(*a, T=T, lanes=n) for a, T, n in dense], 20)
        if B == GRID_BATCH:
            b2_plain_ms = cuda_ms(torch, lambda: run_phases(decode_grouped_batched), 2)
        print(
            f"[3b batched decode kernel] B={B}: both phases bit-exact vs plain (values, states, pointers), "
            f"every stream equals B1's; kernel {b2_ms[B]:.3f} ms (A + B)"
        )
    print(
        f"[3b batched decode kernel] B2 B=10 {b2_ms[10]:.3f} ms, B={GRID_BATCH} {b2_ms[GRID_BATCH]:.3f} ms; "
        f"B1 B=1 {dec_ms:.3f} ms (phase 3, d=1), {b1_dense_ms:.3f} ms (d={RUST_DISTANCES[0]}); "
        f"plain B={GRID_BATCH} {b2_plain_ms:.1f} ms"
    )

    # ---- 3c. B3 and B1 vs plain on the modular shapes (d = 0 token streams)
    synth = read_png_rgb8(SYNTH02)  # stdlib zlib + numpy: the card's machine has no image library
    noise = np.random.default_rng(0).integers(0, 256, img.shape, dtype=np.uint8)
    ll_kernels = {}
    for name, im in (("bench", img), ("synth02", synth), ("noise", noise)):
        hh, ww = im.shape[:2]
        ll_lanes = pick_lanes(3 * hh * ww, 256)
        llay = lossless_layout(hh, ww, ll_lanes)
        tok_l, _nb, mant_l, _p, qs_l = lossless_tokens(
            torch.from_numpy(im).to(dev), height=hh, width=ww, distance=0.0
        )
        tokp_l, mantp_l, rows_l, _f = entropy_inputs(tok_l, mant_l, ll_step_ctx(llay, qs_l), llay, ll_lanes)
        r = hold_stream(
            torch, tokp_l, mantp_l, rows_l, T=llay["T"], t_a=llay["t_a"], lanes=ll_lanes, label=f"3c {name} d=0",
            chains=chains,
        )
        ll_kernels[name] = r
        if name == "noise" and not r["relaunched"]:
            raise AssertionError("the uniform-noise d=0 stream did not overflow B3's default mantissa cap")
        print(
            f"[3c {name} d=0] {llay['n_tokens']} tokens, lanes {ll_lanes}, T {llay['T']} (phase A {llay['t_a']}), "
            f"{llay['n_ctx']} contexts, {r['mbytes']} mantissa bytes; B3 caps {r['default_caps']} -> "
            f"{'relaunched at ' + str(r['caps']) if r['relaunched'] else 'no relaunch'}; B3 and B1 (A + B) "
            f"bit-exact vs plain; B3 {r['enc']['ms']:.3f} ms (plain {r['enc_plain_ms']:.1f} ms), "
            f"B1 {r['dec']['ms']:.3f} ms (plain {r['dec_plain_ms']:.1f} ms)"
        )

    # ---- 3d. the pre-screen kernel; 3e. the DCT kernel at 12 MP
    screen_t = phase_screen(torch, dev, smi)
    dct_t = phase_dct(torch, dev, smi)

    # ---- 4. main path, single image (the counts of phase 3d's and 3e's timing loops are dropped here)
    reset_counts()
    data = encode_image(img, cfg, device=dev)
    out = decode_bytes(data, device=dev)
    n_enc, n_dec, _n2, n_scr, n_dct = read_counts()
    if n_enc < 1 or n_dec < 2 or n_scr != 1 or n_dct < 1:
        raise AssertionError(
            f"main path launches: encode {n_enc}, decode {n_dec}, screen {n_scr}, D1 {n_dct} (want >= 1, >= 2, 1, >= 1)"
        )
    if out.shape != img.shape or out.dtype != np.uint8:
        raise AssertionError(f"decoded {out.shape} {out.dtype}, expected {img.shape} uint8")
    q_db = psnr(img, out)
    bpp = len(data) * 8 / (h * w)
    print(
        f"[4 main path] {len(data)} bytes, {bpp:.4f} bpp, PSNR {q_db:.4f} dB "
        f"(anchor {ANCHOR_PSNR_DB} dB at {ANCHOR_BPP} bpp); launches encode {n_enc}, decode {n_dec}, screen {n_scr}, "
        f"D1 {n_dct} (one a DCT call)"
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

    # ---- 4b. main path, the sweep row under every strategy
    n_b2 = 0
    for strat in Strategy:
        cfg_s = CodecConfig(effort=7, strategy=strat)
        reset_counts()
        datas = encode_image_grid(img, cfg_s, RUST_DISTANCES, device=dev)
        out = decode_bytes_grid_stacked(datas, device=dev)
        ne, n1, n2, ns, nd = read_counts()
        if ne < len(RUST_DISTANCES) or n2 != 2 or n1 != 0 or ns != 1:
            raise AssertionError(
                f"{strat.name} row launches: encode {ne}, B2 {n2}, B1 {n1}, screen {ns} (want >= 10, 2, 0, 1)"
            )
        n_enc += ne
        n_b2 += n2
        n_scr += ns
        n_dct += nd
        if out is None or tuple(out.shape) != (len(RUST_DISTANCES), h, w, 3):
            raise AssertionError(f"{strat.name} row decoded to {None if out is None else tuple(out.shape)}")
        streams = [read_container(b) for b in datas]
        grid_vals = decode_values_grid(streams, dev)
        for i, s in enumerate(streams):
            if not torch.equal(grid_vals[i], decode_values(s, dev)):
                raise AssertionError(f"{strat.name} d={RUST_DISTANCES[i]}: grid values differ from the per-stream decode")
            if not torch.equal(out[i], decode_bytes_device(datas[i], device=dev)):
                raise AssertionError(f"{strat.name} d={RUST_DISTANCES[i]}: grid pixels differ from the per-stream decode")
        out_np = out.cpu().numpy()
        q_row = [psnr(img, o) for o in out_np]
        print(
            f"[4b {strat.name}] launches encode {ne}, B2 {n2}, B1 {n1}, screen {ns}; "
            + ", ".join(f"d={d}: {len(b)} B {q:.4f} dB" for d, b, q in zip(RUST_DISTANCES, datas, q_row))
        )
        if strat is Strategy.BASELINE:
            for d, b in zip(RUST_DISTANCES, datas):
                if b != encode_image(img, CodecConfig(distance=d, effort=7), device=dev):
                    raise AssertionError(f"BASELINE grid container at d={d} differs from encode_image's")
            i1 = RUST_DISTANCES.index(1.0)
            g_db, g_bpp = q_row[i1], len(datas[i1]) * 8 / (h * w)
            if abs(g_db - ANCHOR_PSNR_DB) > PSNR_TOL_DB or abs(g_bpp - ANCHOR_BPP) > BPP_TOL_REL * ANCHOR_BPP:
                raise AssertionError(f"grid d=1 point {g_db:.4f} dB / {g_bpp:.4f} bpp misses the anchor")
            print(
                f"[4b BASELINE] containers byte-identical to encode_image; d=1 point {g_bpp:.4f} bpp, "
                f"{g_db:.4f} dB; values and pixels equal the per-stream decodes on every row"
            )

    # ---- 4c. main path, efforts 8 and 9 (two-pass measured rate, 128 / 256 merges)
    effort_data = {}
    for effort in (8, 9):
        reset_counts()
        data_e = encode_image(img, CodecConfig(distance=1.0, effort=effort), device=dev)
        out_e = decode_bytes(data_e, device=dev)
        ne, n1, n2, ns, nd = read_counts()
        if ne < 1 or n1 < 2 or n2 != 0:
            raise AssertionError(f"e{effort} launches: B3 {ne}, B1 {n1}, B2 {n2} (want >= 1, >= 2, 0)")
        n_enc, n_dec, n_scr, n_dct = n_enc + ne, n_dec + n1, n_scr + ns, n_dct + nd
        lsb_e = int(np.abs(out_e.astype(np.int32) - decode_bytes(data_e, device="cpu")).max())
        if lsb_e > 1:
            raise AssertionError(f"e{effort}: card vs CPU pixels differ by {lsb_e} LSB (> 1)")
        ids = acs_ids(read_container(data_e), dev)
        effort_data[effort] = data_e
        print(
            f"[4c e{effort}] {len(data_e)} bytes, {len(data_e) * 8 / (h * w):.4f} bpp, PSNR {psnr(img, out_e):.4f} dB "
            f"(e7: {len(data)} bytes, {bpp:.4f} bpp, {q_db:.4f} dB); launches B3 {ne}, B1 {n1}; "
            f"card vs CPU pixels max |d| {lsb_e} LSB; strategy ids {ids}"
        )

    # ---- 4d. main path, the modular family at full width
    knobs = encoder_knobs()
    mod_data = {}
    for name, im in (("synth02", synth), ("bench", img)):
        reset_counts()
        d0 = encode_image(im, CodecConfig(distance=0.0), device=dev)
        out0 = decode_bytes(d0, device=dev)
        ne, n1, n2, ns, nd = read_counts()
        if ne < 1 or n1 < 2:
            raise AssertionError(f"{name} d=0 launches: B3 {ne}, B1 {n1} (want >= 1, >= 2)")
        n_enc, n_dec, n_scr, n_dct = n_enc + ne, n_dec + n1, n_scr + ns, n_dct + nd
        if not np.array_equal(out0, im):
            raise AssertionError(f"{name} d=0 does not round-trip exactly")
        s0 = read_container(d0)
        mod_data[name] = d0
        arm = f"palette ({len(s0.acs_extra) // 3} colours)" if s0.acs_extra else "plain YCoCg-R"
        print(
            f"[4d {name} d=0] exact round trip; {len(d0)} bytes, {len(d0) * 8 / im.shape[0] / im.shape[1]:.4f} bpp, "
            f"{arm} arm kept; launches B3 {ne}, B1 {n1}"
        )

    reset_counts()
    picks = encode_image_grid(synth, CodecConfig(effort=7), RUST_DISTANCES, device=dev)
    ne, n1, n2, ns, nd = read_counts()
    n_enc, n_dec, n_scr, n_dct = n_enc + ne, n_dec + n1, n_scr + ns, n_dct + nd
    if ne < 2 * len(RUST_DISTANCES) or n1 < 4 * len(RUST_DISTANCES):
        raise AssertionError(f"synth02 grid pick launches: B3 {ne}, B1 {n1} (want >= 20, >= 40)")
    print(
        f"[4d synth02 grid pick] launches B3 {ne}, B1 {n1} (both families encoded, both decoded per point); "
        + ", ".join(
            f"d={d}: {'modular' if read_container(b).header.lossless else 'VarDCT'} {len(b)} B "
            f"{psnr(synth, decode_bytes(b, device=dev)):.4f} dB"
            for d, b in zip(RUST_DISTANCES, picks)
        )
    )

    synth_t = torch.from_numpy(synth).to(dev)
    reset_counts()
    mrow = _modular_grid_async(synth_t, CodecConfig(), RUST_DISTANCES, "", knobs)()
    mout = decode_bytes_grid_stacked(mrow, device=dev)
    ne, n1, n2, ns, nd = read_counts()
    if ne < len(RUST_DISTANCES) or n2 != 2 or n1 != 0:
        raise AssertionError(f"modular row launches: B3 {ne}, B2 {n2}, B1 {n1} (want >= 10, 2, 0)")
    n_enc, n_b2, n_scr, n_dct = n_enc + ne, n_b2 + n2, n_scr + ns, n_dct + nd
    mstreams = [read_container(b) for b in mrow]
    mvals = decode_values_grid(mstreams, dev)
    errs = []
    for i, (d, s) in enumerate(zip(RUST_DISTANCES, mstreams)):
        if not torch.equal(mvals[i], decode_values(s, dev)):
            raise AssertionError(f"modular row d={d}: grid values differ from the per-stream decode")
        if not torch.equal(mout[i], decode_bytes_device(mrow[i], device=dev)):
            raise AssertionError(f"modular row d={d}: grid pixels differ from the per-stream decode")
        sy, sco, scg = modular_steps(d).tolist()
        bound = (sy + (scg + 1) // 2 + (sco + 1) // 2 + 2) // 2 + 2
        err = int(np.abs(mout[i].cpu().numpy().astype(np.int32) - synth.astype(np.int32)).max())
        if err > bound:
            raise AssertionError(f"modular row d={d}: max error {err} above the bound {bound}")
        errs.append((d, len(mrow[i]), psnr(synth, mout[i].cpu().numpy()), err, bound))
    print(
        f"[4d synth02 modular row] launches B3 {ne}, B2 {n2}, B1 {n1}; values and pixels equal the per-stream "
        "decodes; " + ", ".join(f"d={d}: {nb} B {q:.4f} dB err {e} <= {b}" for d, nb, q, e, b in errs)
    )

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

    def times(label, encode, encoded):
        enc_ts = wall(encode)
        dec_ts = wall(lambda: decode_bytes_device(encoded, device=dev))
        print(
            f"[5 times] {kind} ({smi}): {label}: encode "
            f"{mp / np.median(enc_ts):.2f} MP/s (median {1e3 * np.median(enc_ts):.1f} ms, "
            f"min {1e3 * min(enc_ts):.1f} ms), decode {mp / np.median(dec_ts):.2f} MP/s "
            f"(median {1e3 * np.median(dec_ts):.1f} ms, min {1e3 * min(dec_ts):.1f} ms), {reps} warm runs"
        )

    times("single-image e7 d=1", lambda: encode_image(img, cfg, device=dev), data)
    for effort in (8, 9):
        cfg_e = CodecConfig(distance=1.0, effort=effort)
        times(f"e{effort} d=1", lambda: encode_image(img, cfg_e, device=dev), effort_data[effort])
    times("bench d=0 (lossless)", lambda: encode_image(img, CodecConfig(distance=0.0), device=dev), mod_data["bench"])
    times(
        "synth02 d=0 (palette and plain arms)",
        lambda: encode_image(synth, CodecConfig(distance=0.0), device=dev), mod_data["synth02"],
    )
    synth_mod = _modular_async(synth_t, cfg, "", knobs)
    times("synth02 modular-lossy d=1", lambda: _modular_async(synth_t, cfg, "", knobs)(), synth_mod())

    # ---- 5b. grid times: a row of GRID_BATCH points at d=1, as bench.py times it
    dists = [1.0] * GRID_BATCH
    datas = encode_image_grid(img, cfg, dists, device=dev)
    decode_bytes_grid_stacked(datas, device=dev)
    genc_ts = wall(lambda: encode_image_grid(img, cfg, dists, device=dev))
    gdec_ts = wall(lambda: decode_bytes_grid_stacked(datas, device=dev))
    gmp = GRID_BATCH * mp
    print(
        f"[5b times] {kind} ({smi}): grid of {GRID_BATCH} at d=1: encode "
        f"{gmp / np.median(genc_ts):.2f} MP/s (median {1e3 * np.median(genc_ts):.1f} ms, "
        f"min {1e3 * min(genc_ts):.1f} ms), decode {gmp / np.median(gdec_ts):.2f} MP/s "
        f"(median {1e3 * np.median(gdec_ts):.1f} ms, min {1e3 * min(gdec_ts):.1f} ms), {reps} warm runs"
    )

    # ---- 6. the thesis A/B sweep through the CLI; 6b. legacy stages, effort axis
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    os.makedirs(SWEEP_DIR)
    for phase in (
        lambda: phase_sweep(torch, dev, kind, smi, reset_counts, read_counts),
        lambda: phase_legacy(torch, dev, reset_counts, read_counts),
    ):
        ne, n1, n2, ns, nd = phase()
        n_enc, n_dec, n_b2, n_scr, n_dct = n_enc + ne, n_dec + n1, n_b2 + n2, n_scr + ns, n_dct + nd

    # ---- 7 / 7b. striped JXTS; 8. mesh; 9. serve
    big = {}

    def striped_full():
        counts, big["kernels"] = phase_striped_full(torch, dev, kind, smi, chains, reset_counts, read_counts)
        return counts

    for phase in (
        lambda: phase_striped_small(torch, dev, img, reset_counts, read_counts),
        striped_full,
        lambda: phase_mesh(torch, dev, img, reset_counts, read_counts),
    ):
        ne, n1, n2, ns, nd = phase()
        n_enc, n_dec, n_b2, n_scr, n_dct = n_enc + ne, n_dec + n1, n_b2 + n2, n_scr + ns, n_dct + nd
    phase_serve(torch, dev, kind, smi, img)

    # ---- 10. the standalone coder and the bit packer (no kernel on this path)
    phase_standalone(torch, dev, kind, smi, reset_counts, read_counts)

    # ---- 11. the headline benchmark (bench_torch.py's body), host syncs, traces
    ne, n1, n2, ns, nd = phase_headline(torch, dev, kind, smi, img, reset_counts, read_counts)
    n_enc, n_dec, n_b2, n_scr, n_dct = n_enc + ne, n_dec + n1, n_b2 + n2, n_scr + ns, n_dct + nd

    # ---- 12. the measurement tools (jxl_tpu_torch/tools/)
    ne, n1, n2, ns, nd = phase_tools(torch, dev, kind, smi, img, reset_counts, read_counts)
    n_enc, n_dec, n_b2, n_scr, n_dct = n_enc + ne, n_dec + n1, n_b2 + n2, n_scr + ns, n_dct + nd

    def timing(t: dict) -> dict:
        """The JSON keys of a kernel_time() measurement (the bound is the roofline's: bytes)."""
        return {
            "ms": t["ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "chain_bound_ms": t["chain_bound_ms"], "cycles_per_step": t["cycles_per_step"],
        }

    kernels = [
        {
            "name": "rans_decode", "route": "cuda", "source": "jxl_tpu_torch/csrc/rans_dec.cu",
            "replaces": "jxl_tpu/entropy/pallas_rans.py:239", "launches": n_dec,
            "max_abs_err": max([dec_err, big["kernels"]["dec_err"]] + [r["dec_err"] for r in ll_kernels.values()]),
            "plain_ms": dec_plain_ms, **timing(b3["dec"]), "lanes1024": {
                "plain_ms": big["kernels"]["dec_plain_ms"], **timing(big["kernels"]["dec"]),
            },
        },
        {
            "name": "rans_decode_batched", "route": "cuda", "source": "jxl_tpu_torch/csrc/rans_dec.cu",
            "replaces": "jxl_tpu/entropy/pallas_rans.py:272", "launches": n_b2,
            "max_abs_err": b2_err, "plain_ms": b2_plain_ms, **timing(b2_t[GRID_BATCH]),
        },
        {
            "name": "rans_encode", "route": "cuda", "source": "jxl_tpu_torch/csrc/rans_enc.cu",
            "replaces": "jxl_tpu/entropy/pallas_rans_enc.py:208", "launches": n_enc,
            "max_abs_err": max([enc_err, big["kernels"]["enc_err"]] + [r["enc_err"] for r in ll_kernels.values()]),
            "plain_ms": enc_plain_ms, **timing(b3["enc"]), "lanes1024": {
                "plain_ms": big["kernels"]["enc_plain_ms"], **timing(big["kernels"]["enc"]),
            },
        },
        {
            "name": "screen", "route": "cuda", "source": "jxl_tpu_torch/csrc/screen.cu", "replaces": None,
            "launches": n_scr, "max_abs_err": 0, "plain_ms": screen_t["plain_ms"],
            "ms": screen_t["ms"], "bound_ms": screen_t["bound_ms"], "bound_by": "bytes", "library_ms": None,
        },
        {
            "name": "dct2d", "route": "cuda", "source": "jxl_tpu_torch/csrc/dct.cu", "replaces": None,
            "launches": n_dct, "max_rel_err": dct_t["max_rel_err"], "plain_ms": None, "ms": dct_t["ms"],
            "bound_ms": dct_t["bound_ms"], "bound_by": "bytes", "library_ms": dct_t["library_ms"],
        },
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
