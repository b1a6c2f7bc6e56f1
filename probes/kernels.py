#!/usr/bin/env python3
"""Times of the port's CUDA kernels (jxl_tpu_torch/csrc/*.cu) on one card,
each beside its bounds:

    python3 probes/kernels.py [--parent-csrc DIR]

Run from the repository root; needs one CUDA card (exits 2 without). The
kernels' correctness is the card suite's (`tests/test_torch_cuda.py`);
this probe times them. Each time is a CUDA-event mean of 20 launches after
one warm-up, with the SM clock and power draw that nvidia-smi reads right
after the window. Lines, in order:

- `[card]` the card's name and power limit; `[build]` every source built
  with nvcc at once (seconds), ptxas's register and spill lines;
- `[chains]` SM cycles per link of each dependent chain of the rANS scans
  (`kernel_bounds.measure_chain_cycles`), of which the chain bounds below
  are made;
- `[B3]`, `[B1]` the encode and the two-phase decode on the bench image's
  d=1 stream (512x768, lanes 256), on one 1024-lane stripe of the striped
  8192x8704 bench-style image, and on the d = 0 streams of the bench
  image, test_images/synth/synth02.png and uniform noise (B3 relaunched
  at grown caps there): ns and SM cycles per step, the roofline bound
  (`kernel_bounds`) and the chain bound (T x the measured step chain);
- `[B2]` the batched decode of the bench image's grid rows of 10 and 32
  points, both phases, and of the first 1, 4, 10, 16, 32 streams of the
  latter;
- `[S1]` the pre-screen at 4032x3024 (photo, graphics), 4097x4096 (stride
  4) and 768x512: the launch alone and `screen_count` with its fill and
  read-back, beside the bound of one read of the grid's rows;
- `[D1]` the DCT, forward and inverse, at the 12 MP views of the encoder's
  8x8, 4x4 and 64x64 calls, beside its bound (one read and one write, or
  its FLOPs, the larger) and `torch.matmul` on the same view;
- `[H1]` the context histograms, both forms (the entropy stage's stepped
  tables and the front end's AC counts), on the inputs of one d=1 e7
  encode of a 4032x3024 photo and of the bench image: the launch alone and
  the wrapper with its zero fill, beside the bound of one read of the
  tokens and keys and one write of the counts, `torch.bincount` on the
  prebuilt index (ATen's kernel with its two read-backs) and the plain
  version whole (index build and bincount), the parent's code;
- `[launches]` each kernel entry's launches in one main-path round trip
  of the bench image at d=1 e7 and in one 32-point grid row, read as
  differences of `cuda_build.launch_counts()`;
- `[step clock]` a copy of rans_dec.cu with SM-clock reads between the
  parts of the state warp's step (built under build/probe/, never used by
  the codec) decodes the bench image's d=1 stream: SM cycles per step of
  each part and of the rest of the chunk loop, beside the copy's and the
  kernel's own times (the reads cost cycles themselves);
- the last line, one JSON object: the card, the chains, the main path's
  launches and each kernel's times.

With `--parent-csrc DIR` (another version's jxl_tpu_torch/csrc, e.g. the
parent commit's, unpacked with `git archive` into a git-ignored directory)
it then builds that version's rANS sources under build/probe/, launches
them through the same entry declarations (`cuda_build.ENTRIES`) on the
streams above and the grid rows, holds every output equal to this
version's, and times each pair in turns (old, new, new, old).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PROBE_BUILD = REPO / "build" / "probe"
SYNTH02 = REPO / "test_images" / "synth" / "synth02.png"
RUST_DISTANCES = (0.5, 1.0, 1.5, 3.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0)  # the reference harness's row
GRID_BATCH = 32  # points of bench.py's grid row

# SM-clock reads inserted into the state warp of rans_dec.cu: (anchor, text
# inserted before it). Part k runs from read k to read k + 1.
PARTS = ("row c8 loads", "probes 32/16/8", "probes 4/2/1", "f, c, multiply-add, test", "word ranks",
         "word reads, merge", "symbol store")
CLOCK_EDITS = (
    ("  // one scan step t\n", "  long long clk_acc[7] = {0, 0, 0, 0, 0, 0, 0};\n"),
    ("    const int32_t* row = rring + (t & (ROW_SLOTS - 1)) * GROUP;\n", "    const long long k0 = clock64();\n"),
    ("    // the plain version's 6-probe binary search", "    const long long k1 = clock64();\n"),
    ("#pragma unroll\n    for (int p = 4; p >= 1; p >>= 1) {", "    const long long k2 = clock64();\n"),
    ("    uint32_t xd[LPT];\n", "    const long long k3 = clock64();\n"),
    ("    // word ranks: one ballot", "    const long long k4 = clock64();\n"),
    ("    // unconditional ring reads", "    const long long k5 = clock64();\n"),
    ("    gptr += wtot;\n", "    const long long k6 = clock64();\n"),
    ("  };\n\n  const int n_chunks = (T + CHUNK - 1) / CHUNK;\n#pragma unroll 1\n  for (int c = 0; c < n_chunks; ++c) {\n"
     "    // the copies of chunk c have landed",
     "    const long long k7 = clock64();\n    const long long ks[8] = {k0, k1, k2, k3, k4, k5, k6, k7};\n"
     "#pragma unroll\n    for (int j = 0; j < 7; ++j) clk_acc[j] += ks[j + 1] - ks[j];\n"),
    ("  cp_async_wait_all();\n#pragma unroll\n  for (int k = 0; k < LPT; ++k) st_out",
     "  if (lane == 0) {\n    atomicAdd(&g_step_clk[0], (unsigned long long)(clock64() - clk_start));\n"
     "    for (int j = 0; j < 7; ++j) atomicAdd(&g_step_clk[1 + j], (unsigned long long)clk_acc[j]);\n  }\n"),
)
CLOCK_HEAD = (
    "__device__ __forceinline__ void decode_states(",
    "__device__ unsigned long long g_step_clk[8];  // the whole loop, then the parts\n\n",
)
CLOCK_TAIL = """
extern "C" int jxl_step_clock(void* out8, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(g_step_clk, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out8, g_step_clk, 8 * sizeof(unsigned long long));
}
"""


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of fn on the current stream (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_sample() -> dict:
    """The card's SM clock (MHz), power draw and power limit (W) now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    mhz, draw, limit = (float(v) for v in out.split(","))
    return dict(mhz=mhz, draw=draw, limit=limit)


def scan_time(fn, *, T: int, nbytes: int, step_cycles: float) -> dict:
    """fn's time against the roofline bound of `nbytes` and the chain bound
    of T steps of `step_cycles` measured cycles, at the clock sampled right
    after the window."""
    from jxl_tpu_torch.entropy.kernel_bounds import chain_bound_ms, cycles_per_step, roofline_ms

    ms = cuda_ms(fn)
    s = smi_sample()
    return dict(
        ms=ms, T=T, nbytes=nbytes, mhz=s["mhz"], draw=s["draw"], cycles_per_step=cycles_per_step(ms, T, s["mhz"]),
        bound_ms=roofline_ms(nbytes), chain_bound_ms=chain_bound_ms(T, step_cycles, s["mhz"]),
    )


def scan_text(k: dict) -> str:
    return (
        f"{k['ms']:.3f} ms, {k['ms'] * 1e6 / k['T']:.1f} ns = {k['cycles_per_step']:.0f} cycles per step (T {k['T']}, "
        f"SM {k['mhz']:.0f} MHz, {k['draw']:.0f} W drawn); roofline {1e3 * k['bound_ms']:.2f} us "
        f"({k['nbytes'] / 1e6:.3f} MB, {100 * k['bound_ms'] / k['ms']:.2f}%), chain "
        f"{k['chain_bound_ms']:.3f} ms ({100 * k['chain_bound_ms'] / k['ms']:.1f}%)"
    )


def front_packed(bucket, counts):
    """Back-filled encode buckets [G, cap] -> decode buffers with each
    group's stream at the front of its row."""
    G, cap = bucket.shape
    c = counts.tolist()
    out = torch.zeros((G, max(1, max(c))), dtype=torch.int32, device=bucket.device)
    for g in range(G):
        out[g, : c[g]] = bucket[g, cap - c[g] :]
    return out


def build_lib(src_text: str, name: str) -> ctypes.CDLL:
    """nvcc (the package's flags) of one source text into build/probe/."""
    from jxl_tpu_torch.cuda_build import NVCC_FLAGS, _nvcc

    digest = hashlib.sha256(src_text.encode() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    cu, so = PROBE_BUILD / f"{name}-{digest}.cu", PROBE_BUILD / f"{name}-{digest}.so"
    if not so.exists():
        cu.write_text(src_text)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def clocked_source(src: str) -> str:
    """rans_dec.cu with the step clock inserted; raises if an anchor moved."""
    def before(s, anchor, text):
        if s.count(anchor) != 1:
            raise RuntimeError(f"step clock: anchor found {s.count(anchor)} times: {anchor!r}")
        return s.replace(anchor, text + anchor)

    for anchor, text in (CLOCK_HEAD, *CLOCK_EDITS):
        src = before(src, anchor, text)
    src = before(src, "  const int n_chunks = (T + CHUNK - 1) / CHUNK;\n#pragma unroll 1\n  for (int c = 0; c < n_chunks; ++c) {\n"
                 "    // the copies of chunk c have landed", "  const long long clk_start = clock64();\n")
    return src + CLOCK_TAIL


class Stream:
    """One padded token stream: its encode inputs, and its decode inputs
    from the package's encode. `lib` (another build of the source) runs
    the same entries through the same declarations."""

    def __init__(self, label, tokp, mantp, rows, T, t_a, lanes):
        from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda

        self.label, self.tokp, self.mantp, self.rows, self.T, self.t_a, self.lanes = label, tokp, mantp, rows, T, t_a, lanes
        capw, capm = enc_caps(T, lanes)
        enc = encode_grouped_cuda(tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm)
        self.caps = dict(capw=enc[0].shape[1], capm=enc[1].shape[1])
        self.relaunched = self.caps != dict(capw=capw, capm=capm)
        self.n_words, self.n_mbytes = int(enc[3].sum()), int(enc[4].sum())
        self.words, self.mant, self.states = front_packed(enc[0], enc[3]), front_packed(enc[1], enc[4]), enc[2]
        self.ptr0 = torch.zeros((2, lanes // 128), dtype=torch.int32, device=tokp.device)
        self.rows_a, self.rows_b = rows[:t_a].contiguous(), rows[t_a:].contiguous()

    def encode(self, lib=None):
        from jxl_tpu_torch.entropy import cuda_rans_enc

        return cuda_rans_enc._launch(self.tokp, self.mantp, self.rows, T=self.T, lanes=self.lanes, **self.caps, lib=lib)

    def decode(self, lib=None):
        """Both phases, joined by the carry, through B1's entry."""
        from jxl_tpu_torch.entropy import cuda_rans

        kw = dict(lanes=self.lanes, B=1, lib=lib)
        va, st, p = cuda_rans._launch("rans_decode", self.words, self.mant, self.states, self.rows_a, self.ptr0,
                                      T=self.t_a, **kw)
        vb, st2, p2 = cuda_rans._launch("rans_decode", self.words, self.mant, st.reshape(self.lanes), self.rows_b, p,
                                        T=self.T - self.t_a, **kw)
        return va, st, p, vb, st2, p2

    def times(self, chains: dict) -> dict:
        """B3 and B1 (A + B) against their bounds."""
        from jxl_tpu_torch.entropy.kernel_bounds import decode_bytes, encode_bytes

        enc = scan_time(self.encode, T=self.T, nbytes=encode_bytes(self.T, self.lanes, self.n_words, self.n_mbytes),
                        step_cycles=chains["encode_step"])
        wa, ba = (int(v) for v in self.decode()[2].sum(dim=1).tolist())
        nbytes = decode_bytes(self.t_a, self.lanes, wa, ba) + decode_bytes(
            self.T - self.t_a, self.lanes, self.n_words - wa, self.n_mbytes - ba)
        dec = scan_time(self.decode, T=self.T, nbytes=nbytes, step_cycles=chains["decode_step"])
        print(f"[B3 {self.label}] lanes {self.lanes}, {'relaunched at ' + str(self.caps) if self.relaunched else 'default caps'}: "
              f"{scan_text(enc)}", flush=True)
        print(f"[B1 {self.label}] (A + B) {scan_text(dec)}", flush=True)
        return dict(encode=enc, decode=dec)


def _stream_of(label, img, dev, lanes=None):
    """The d=1 e7 stream of `img` (lanes from pick_lanes unless given)."""
    from jxl_tpu_torch.codec.encode import _step_ctx_v8, entropy_inputs, pick_lanes, tokens_from_rgb
    from jxl_tpu_torch.codec.layout import padded_layout, token_layout

    h, w = img.shape[:2]
    lanes = lanes or pick_lanes(token_layout(h, w)["n_tokens"], 256)
    lay = padded_layout(h, w, lanes)
    token, _nb, mant, _p, q_sorted, _v = tokens_from_rgb(
        torch.from_numpy(np.ascontiguousarray(img)).to(dev), 1.0, height=h, width=w, effort=7)
    tokp, mantp, rows, _f = entropy_inputs(token, mant, _step_ctx_v8(lay, q_sorted), lay, lanes)
    return Stream(label, tokp, mantp, rows, lay["T"], lay["t_a"], lanes)


def streams(dev):
    """The bench image's d=1 stream, one stripe's of the striped
    8192x8704 bench-style image (1024 lanes), and three d = 0 streams."""
    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.codec.encode import entropy_inputs, pick_lanes
    from jxl_tpu_torch.codec.layout import lossless_layout
    from jxl_tpu_torch.codec.lossless import ll_step_ctx, lossless_tokens
    from jxl_tpu_torch.codec.tiled import default_n_stripes, stripe_widths
    from jxl_tpu_torch.core.io import read_png_rgb8

    img = synth_kodak()  # the bench image (bench.py:synth_kodak, 512x768, seed 0)
    out = [_stream_of("bench d=1", img, dev)]
    big = synth_kodak(8192, 8704, seed=1)
    widths = stripe_widths(8704, default_n_stripes(8192, 8704))
    k = len(widths) // 2
    x0 = sum(widths[:k])
    out.append(_stream_of(f"stripe {k} of 8192x8704 d=1", big[:, x0 : x0 + widths[k]], dev, lanes=1024))
    del big
    noise = np.random.default_rng(0).integers(0, 256, img.shape, dtype=np.uint8)
    for name, im in (("bench", img), ("synth02", read_png_rgb8(str(SYNTH02))), ("noise", noise)):
        hh, ww = im.shape[:2]
        ll_lanes = pick_lanes(3 * hh * ww, 256)
        llay = lossless_layout(hh, ww, ll_lanes)
        tok_l, _nb, mant_l, _p, qs_l = lossless_tokens(torch.from_numpy(im).to(dev), height=hh, width=ww, distance=0.0)
        tokp_l, mantp_l, rows_l, _f = entropy_inputs(tok_l, mant_l, ll_step_ctx(llay, qs_l), llay, ll_lanes)
        out.append(Stream(f"{name} d=0", tokp_l, mantp_l, rows_l, llay["T"], llay["t_a"], ll_lanes))
    return img, out


def grid_calls(dev, img, dists):
    """B2's launches (arguments) of the grid decode of the bench image
    over `dists`, as decode_bytes_grid_stacked makes them."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.container import read_container
    from jxl_tpu_torch.codec.decode import _padded_values
    from jxl_tpu_torch.codec.encode import encode_image_grid
    from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_batched_cuda

    row = [read_container(b) for b in encode_image_grid(img, CodecConfig(distance=1.0, effort=7), dists, device=dev)]
    calls = []

    def capture(*args, T, lanes):
        calls.append((args, T, lanes))
        return decode_grouped_batched_cuda(*args, T=T, lanes=lanes)

    _padded_values(row, dev, capture)
    torch.cuda.synchronize()
    return calls


def batched(calls, nb, lib=None):
    """B2 on the first nb streams of each captured launch."""
    from jxl_tpu_torch.entropy import cuda_rans

    out = []
    for (words, mant, states, rows, ptrs), T, lanes in calls:
        G = lanes // 128
        out += cuda_rans._launch("rans_decode_batched", words[: nb * G].contiguous(), mant[: nb * G].contiguous(),
                                 states[:nb].contiguous(), rows[:, :nb].contiguous(), ptrs[:, : nb * G].contiguous(),
                                 T=T, lanes=lanes, B=nb, lib=lib)
    return out


def b2_times(dev, img, chains: dict) -> tuple:
    """B2 on the grid rows of 10 and 32 points; returns the 32-point time
    and the captured launches of both rows."""
    from jxl_tpu_torch.entropy.kernel_bounds import decode_bytes

    rows = {10: RUST_DISTANCES, GRID_BATCH: tuple(float(d) for d in np.linspace(0.5, 14.0, GRID_BATCH))}
    calls, t32 = {}, None
    for B, dists in rows.items():
        calls[B] = grid_calls(dev, img, dists)
        nbytes = 0
        for a, T, lanes in calls[B]:  # each phase: the words and bytes it consumes, from its pointers
            used = (batched([(a, T, lanes)], B)[2] - a[4]).reshape(2, B, lanes // 128).sum(dim=(1, 2)).tolist()
            nbytes += decode_bytes(T, lanes, *used, B=B)
        t = scan_time(lambda: batched(calls[B], B), T=sum(T for _a, T, _l in calls[B]), nbytes=nbytes,
                      step_cycles=chains["decode_step"])
        print(f"[B2 B={B}] (A + B) {scan_text(t)}", flush=True)
        if B == GRID_BATCH:
            t32 = t
            scale = [(nb, cuda_ms(lambda: batched(calls[B], nb))) for nb in (1, 4, 10, 16, 32)]
            print("[B2 scaling] first nb streams of the 32-point row, A + B: "
                  + ", ".join(f"B={nb} {ms:.3f} ms" for nb, ms in scale), flush=True)
    return t32, calls


def s1_times(dev) -> dict:
    """The screen kernel alone and screen_count whole, beside the bound of
    one read of every s-th row."""
    from jxl_tpu_torch.bench.headline import PEAK_BW
    from jxl_tpu_torch.codec.screen import _launch, screen_count, screen_stride
    from jxl_tpu_torch.tools.make_test_images import synth_graphics, synth_photo

    out = {}
    for name, (hh, ww), make in (
        ("photo", (3024, 4032), synth_photo), ("graphics", (3024, 4032), synth_graphics),
        ("graphics", (4097, 4096), synth_graphics), ("photo", (512, 768), synth_photo),
    ):
        frame = torch.from_numpy(np.ascontiguousarray(make(hh, ww, 0))).to(dev)
        s = screen_stride(hh, ww)
        acc = torch.zeros(1, dtype=torch.int64, device=dev)
        ms = cuda_ms(lambda: _launch(frame, s, acc))
        whole_ms = cuda_ms(lambda: screen_count(frame))
        nbytes = 3 * -(-hh // s) * ww  # every s-th row, read whole
        bound_ms = 1e3 * nbytes / PEAK_BW
        smi = smi_sample()
        print(f"[S1 {name} {hh}x{ww}] stride {s}: kernel {1e3 * ms:.2f} us, screen_count with its fill and read-back "
              f"{1e3 * whole_ms:.1f} us; bound {1e3 * bound_ms:.2f} us ({nbytes / 1e6:.2f} MB, {100 * bound_ms / ms:.1f}%; "
              f"SM {smi['mhz']:.0f} MHz)", flush=True)
        out.setdefault(f"{name} {hh}x{ww}", dict(ms=ms, whole_ms=whole_ms, bound_ms=bound_ms))
    return out


def d1_times(dev) -> dict:
    """D1 at the 12 MP views of the encoder's 8x8, 4x4 and 64x64 calls
    (`search_acs`), forward and inverse, beside its bound and
    torch.matmul on the view (the bases already on the card)."""
    from jxl_tpu_torch.bench.headline import PEAK_BW, PEAK_FLOPS
    from jxl_tpu_torch.transforms.dct import dct2d, dct_matrix, idct2d

    g = torch.Generator(device=dev).manual_seed(17)
    planes = torch.randn(3, 3024, 4032, generator=g, device=dev) * 64
    blocks = planes.reshape(3, 378, 8, 504, 8).permute(0, 1, 3, 2, 4)
    views = {
        "8x8": blocks,
        "4x4": blocks.reshape(*blocks.shape[:-2], 2, 4, 2, 4).permute(0, 1, 2, 3, 5, 4, 6),
        "64x64": planes[:, :3008].reshape(3, 47, 64, 63, 64).permute(0, 1, 3, 2, 4),
    }
    out = {}
    for name, x in views.items():
        n, m = x.shape[-2:]
        dn, dm = dct_matrix(n, dev), dct_matrix(m, dev)
        for inverse, fn in ((False, dct2d), (True, idct2d)):
            gemm = (lambda: torch.matmul(torch.matmul(dn.T, x), dm)) if inverse else (
                lambda: torch.matmul(torch.matmul(dn, x), dm.T))
            ms, lib_ms = cuda_ms(lambda: fn(x)), cuda_ms(gemm)
            nbytes = 2 * 4 * x.numel()
            bytes_ms, flops_ms = 1e3 * nbytes / PEAK_BW, 1e3 * 2 * (n + m) * x.numel() / PEAK_FLOPS
            bound_ms = max(bytes_ms, flops_ms)
            kind = "idct" if inverse else "dct"
            print(f"[D1 {kind} {name}] {tuple(x.shape)}: kernel {1e3 * ms:.1f} us, bound {1e3 * bound_ms:.1f} us "
                  f"({'bytes' if bytes_ms >= flops_ms else 'FLOPs'}, {100 * bound_ms / ms:.1f}%); torch.matmul on the "
                  f"view {1e3 * lib_ms:.1f} us", flush=True)
            out[f"{kind} {name}"] = dict(ms=ms, bound_ms=bound_ms, library_ms=lib_ms)
    return out


def h1_inputs(dev, img) -> dict:
    """The arguments of the encoder's two histogram calls in one d=1 e7
    encode of `img`, captured at the names `codec.encode` calls."""
    from jxl_tpu_torch.codec import encode
    from jxl_tpu_torch.codec.config import CodecConfig

    names = {"stepped": "_histogram_stepped", "ac": "_ac_counts4"}
    real = {form: getattr(encode, name) for form, name in names.items()}
    seen = {}

    def capture(form):
        def run(*args):
            seen[form] = args
            return real[form](*args)

        return run

    for form, name in names.items():
        setattr(encode, name, capture(form))
    try:
        encode.encode_image(img, CodecConfig(distance=1.0, effort=7), device=dev)
    finally:
        for form, name in names.items():
            setattr(encode, name, real[form])
    return seen


def h1_times(dev) -> dict:
    """H1, both forms, on the encoder's own inputs at 12 MP and at the bench
    image's size: the launch alone and the wrapper with its fill, beside
    its byte bound, torch.bincount on the prebuilt index and the plain
    version whole, each checked equal to the kernel's counts first."""
    from jxl_tpu_torch.bench.headline import PEAK_BW, synth_kodak
    from jxl_tpu_torch.codec import histogram
    from jxl_tpu_torch.cuda_build import launch
    from jxl_tpu_torch.entropy.tokens import ALPHABET
    from jxl_tpu_torch.tools.make_test_images import synth_photo

    forms = {
        "stepped": (histogram.histogram_stepped_cuda, histogram.histogram_stepped_plain),
        "ac": (histogram.ac_counts4_cuda, histogram.ac_counts4_plain),
    }
    out = {}
    for size, img in (("4032x3024", synth_photo(3024, 4032, 0)), ("512x768", synth_kodak())):
        seen = h1_inputs(dev, img)
        for form, (kernel, plain) in forms.items():
            args = seen[form]
            tok, key = args[0], args[1]
            counts = kernel(*args)
            if not torch.equal(counts, plain(*args)):
                raise AssertionError(f"H1 {form} {size}: the kernel's counts differ from torch.bincount's")
            if form == "stepped":
                lanes, n_rows, nb = args[2], args[3], 0
                idx = histogram.stepped_index(*args[:3])
                shape = f"T {key.numel()} x lanes {lanes}, {n_rows} contexts"
            else:
                lanes, n_rows, nb = histogram.AC_POS, counts.numel() // ALPHABET, tok.shape[1]
                idx = histogram.ac_index(tok, key)
                shape = f"[3, {nb}, 63] tokens, {n_rows} rows"
            acc = torch.zeros_like(counts)
            ms = cuda_ms(lambda: launch("hist", dev, tok.data_ptr(), key.data_ptr(), key.numel(), lanes, n_rows, nb,
                                        acc.data_ptr()))
            whole_ms = cuda_ms(lambda: kernel(*args))
            lib_ms = cuda_ms(lambda: torch.bincount(idx, minlength=counts.numel()))
            plain_ms = cuda_ms(lambda: plain(*args))
            nbytes = 4 * tok.numel() + 8 * key.numel() + 8 * counts.numel()
            bound_ms = 1e3 * nbytes / PEAK_BW
            smi = smi_sample()
            print(f"[H1 {form} {size}] {shape} ({tok.numel() / 1e6:.2f} M tokens): kernel {1e3 * ms:.1f} us, with its "
                  f"fill {1e3 * whole_ms:.1f} us; bound {1e3 * bound_ms:.1f} us ({nbytes / 1e6:.2f} MB, "
                  f"{100 * bound_ms / ms:.1f}%); torch.bincount on the index {lib_ms:.3f} ms, the plain version whole "
                  f"{plain_ms:.3f} ms (SM {smi['mhz']:.0f} MHz)", flush=True)
            out[f"{form} {size}"] = dict(ms=ms, whole_ms=whole_ms, bound_ms=bound_ms, library_ms=lib_ms,
                                         plain_ms=plain_ms)
            del idx
    return out


def main_path_launches(dev, img) -> dict:
    """Each kernel entry's launches in one main-path round trip of the
    bench image (encode_image and decode_bytes at d=1 e7) and in one grid
    row of GRID_BATCH points (encode_image_grid and
    decode_bytes_grid_stacked), as differences of `launch_counts()`."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes, decode_bytes_grid_stacked
    from jxl_tpu_torch.codec.encode import encode_image, encode_image_grid
    from jxl_tpu_torch.cuda_build import launch_counts

    dists = tuple(float(d) for d in np.linspace(0.5, 14.0, GRID_BATCH))
    runs = {
        "round trip d=1 e7": lambda: decode_bytes(encode_image(img, CodecConfig(distance=1.0, effort=7), device=dev),
                                                  device=dev),
        f"grid row of {GRID_BATCH}": lambda: decode_bytes_grid_stacked(
            encode_image_grid(img, CodecConfig(effort=7), dists, device=dev), device=dev),
    }
    out = {}
    for label, run in runs.items():
        c0 = launch_counts()
        run()
        torch.cuda.synchronize()
        out[label] = {k: v - c0[k] for k, v in launch_counts().items() if k != "chain_probe"}
        print(f"[launches {label}] " + ", ".join(f"{k} {v}" for k, v in out[label].items()), flush=True)
    return out


def step_clock(lib_clk, s: Stream) -> None:
    """The clocked copy on stream s: cycles per step of each part."""
    same(f"step clock {s.label}", s.decode(lib_clk), s.decode())
    fn = lib_clk.jxl_step_clock  # a probe-only symbol: ctypes passes None and the array as pointers
    if fn(None, 1) != 0:
        raise RuntimeError("step clock reset failed")
    s.decode(lib_clk)
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 8)()
    if fn(out, 0) != 0:
        raise RuntimeError("step clock read failed")
    steps = s.T * (s.lanes // 128)  # summed over the groups' CTAs
    total, parts = out[0] / steps, [v / steps for v in out[1:]]
    ms_clk, ms = cuda_ms(lambda: s.decode(lib_clk)), cuda_ms(s.decode)
    mhz = smi_sample()["mhz"]
    print(
        f"[step clock {s.label}] SM cycles per step of the state warp, T {s.T}: "
        + ", ".join(f"{name} {v:.1f}" for name, v in zip(PARTS, parts))
        + f", rest of the chunk loop {total - sum(parts):.1f}; loop {total:.1f} in all. Clocked copy {ms_clk:.3f} ms, "
        f"kernel {ms:.3f} ms ({ms * mhz * 1e3 / s.T:.0f} cycles a step at SM {mhz:.0f} MHz)", flush=True
    )


def same(label, a, b):
    torch.cuda.synchronize()
    for x, y in zip(a, b, strict=True):
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: the two versions' outputs differ")


def turns(label, old_fn, new_fn):
    """old, new, new, old."""
    o1, n1, n2, o2 = (cuda_ms(f) for f in (old_fn, new_fn, new_fn, old_fn))
    mhz = smi_sample()["mhz"]
    print(f"[A/B {label}] old {o1:.3f} ms, new {n1:.3f} ms, new {n2:.3f} ms, old {o2:.3f} ms "
          f"({(o1 + o2) / (n1 + n2):.2f}x; SM {mhz:.0f} MHz after)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", metavar="DIR", help="another version's jxl_tpu_torch/csrc, timed in turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernels: no CUDA device", file=sys.stderr)
        return 2
    from jxl_tpu_torch.bench.headline import smi_line
    from jxl_tpu_torch.core.device import resolve_device
    from jxl_tpu_torch.cuda_build import BUILD_LOGS, CSRC, ENTRIES, build
    from jxl_tpu_torch.entropy.kernel_bounds import PROBE_LINKS, measure_chain_cycles

    dev = resolve_device("cuda:0")
    card = smi_line(dev)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    sources = sorted({e.source for e in ENTRIES.values()})
    probe_jobs = {"clocked": (clocked_source((CSRC / "rans_dec.cu").read_text()), "rans_dec_clocked")}
    if args.parent_csrc:
        for name in ("rans_dec", "rans_enc"):
            probe_jobs[f"old {name}"] = ((Path(args.parent_csrc) / f"{name}.cu").read_text(), f"parent_{name}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + len(probe_jobs)) as ex:
        built = ex.map(build, sources)
        libs = dict(zip(probe_jobs, ex.map(lambda j: build_lib(*j), probe_jobs.values())))
        list(built)
    print(f"[build] {' + '.join(sources)} and {len(probe_jobs)} probe copies built in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    chains = measure_chain_cycles(dev)
    print(f"[chains] SM cycles per link, one warp, {PROBE_LINKS} links (csrc/chain_probe.cu): "
          + ", ".join(f"{k} {v:.2f}" for k, v in chains.items()), flush=True)

    img, ss = streams(dev)
    scans = {s.label: s.times(chains) for s in ss}
    b2, calls = b2_times(dev, img, chains)
    s1 = s1_times(dev)
    d1 = d1_times(dev)
    h1 = h1_times(dev)
    launches = main_path_launches(dev, img)
    step_clock(libs["clocked"], ss[0])

    def keep(t):
        return {k: t[k] for k in ("ms", "bound_ms", "chain_bound_ms", "cycles_per_step")}

    bench, stripe = scans["bench d=1"], scans[ss[1].label]
    print(json.dumps({"card": card, "chains": chains, "launches": launches, "kernels": {
        "rans_decode": {**keep(bench["decode"]), "lanes1024": keep(stripe["decode"])},
        "rans_decode_batched": keep(b2),
        "rans_encode": {**keep(bench["encode"]), "lanes1024": keep(stripe["encode"])},
        "screen": s1,
        "dct2d": d1,
        "hist": h1,
    }}), flush=True)
    if not args.parent_csrc:
        return 0

    old_d, old_e = libs["old rans_dec"], libs["old rans_enc"]
    for s in ss:
        same(f"{s.label} B3", s.encode(old_e), s.encode())
        same(f"{s.label} B1", s.decode(old_d), s.decode())
        turns(f"{s.label} B3", lambda: s.encode(old_e), s.encode)
        turns(f"{s.label} B1 (A + B)", lambda: s.decode(old_d), s.decode)
    for B, row in calls.items():
        for nb in (1, 4, 10, 16, 32) if B == GRID_BATCH else (B,):
            same(f"B2 B={nb}", batched(row, nb, old_d), batched(row, nb))
            turns(f"B2 row of {B}, first {nb} streams (A + B)", lambda: batched(row, nb, old_d), lambda: batched(row, nb))
    return 0


if __name__ == "__main__":
    sys.exit(main())
