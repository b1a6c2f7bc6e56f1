#!/usr/bin/env python3
"""Timing probes of the rANS scan kernels (jxl_tpu_torch/csrc/rans_dec.cu,
rans_enc.cu) on one CUDA card, beside chip_smoke.py:

    python3 probes/rans_kernels.py [--parent-csrc DIR]

Run from the repository root. Two probes, each printing its lines:

- step clock: a copy of rans_dec.cu with SM-clock reads inserted between
  the parts of the state warp's step (built under build/probe/, never used
  by the codec) decodes the bench image's d=1 stream (both phases); prints
  SM cycles per step for each part and the rest of the chunk loop
  (waits, refills, the hand-over), beside the copy's and the kernel's own
  times. The reads cost cycles themselves: the copy's total says how much.
- A/B, with `--parent-csrc DIR` (another version's jxl_tpu_torch/csrc,
  e.g. the parent commit's, unpacked with `git archive` into a git-ignored
  directory): both versions' kernels built side by side and launched
  through the same ctypes calls on the streams chip_smoke.py times (the
  bench image at d=1, B2 on its 10- and 32-point grid rows and on the
  first 1, 4, 10, 16 and 32 streams of the latter, the d = 0 streams of
  the bench image, synth02.png and uniform noise); every output must be
  equal, and each pair is timed in turns (old, new, new, old), CUDA-event
  means of 20 launches.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

PROBE_BUILD = REPO / "build" / "probe"

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
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    return ctypes.CDLL(str(so))


def decode_launch(torch, lib, symbol, words, mant, states, rows, ptrs, *, T, lanes, B):
    """One decode launch through C entry `symbol` of `lib` (the arguments
    of jxl_tpu_torch/entropy/cuda_rans.py:_launch)."""
    from jxl_tpu_torch.entropy.cuda_rans import i32_to_u32, u32_to_i32

    G = lanes // 128
    dev = words.device
    fn = getattr(lib, symbol)
    batched = [ctypes.c_int] if symbol == "jxl_rans_decode_batched" else []
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, *batched, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    st_in = u32_to_i32(states)
    values = torch.empty((B, T * lanes), dtype=torch.int32, device=dev)
    st_out = torch.empty((B, lanes), dtype=torch.int32, device=dev)
    ptr_out = torch.empty((2, B * G), dtype=torch.int32, device=dev)
    err = fn(words.data_ptr(), words.shape[1], mant.data_ptr(), mant.shape[1], rows.data_ptr(), T, st_in.data_ptr(),
             ptrs.data_ptr(), G, *([B] if batched else []), values.data_ptr(), st_out.data_ptr(), ptr_out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    return values, i32_to_u32(st_out), ptr_out


def encode_launch(torch, lib, tokp, mant, rows, *, T, lanes, capw, capm):
    """One launch of jxl_rans_encode of `lib` (the arguments of
    jxl_tpu_torch/entropy/cuda_rans_enc.py:_launch)."""
    from jxl_tpu_torch.entropy.cuda_rans import i32_to_u32

    G = lanes // 128
    dev = tokp.device
    fn = lib.jxl_rans_encode
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    words = torch.zeros((G, capw), dtype=torch.int32, device=dev)
    mbytes = torch.zeros((G, capm), dtype=torch.int32, device=dev)
    states = torch.empty(lanes, dtype=torch.int32, device=dev)
    counts = torch.empty((2, G), dtype=torch.int32, device=dev)
    err = fn(tokp.data_ptr(), mant.data_ptr(), rows.data_ptr(), T, G, capw, capm, words.data_ptr(), mbytes.data_ptr(),
             states.data_ptr(), counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jxl_rans_encode launch failed: CUDA error {err}")
    return words, mbytes, i32_to_u32(states), counts[0], counts[1]


class Stream:
    """One padded token stream: its encode inputs, and its decode inputs
    from the package's encode."""

    def __init__(self, torch, label, tokp, mantp, rows, T, t_a, lanes):
        from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda

        self.label, self.tokp, self.mantp, self.rows, self.T, self.t_a, self.lanes = label, tokp, mantp, rows, T, t_a, lanes
        capw, capm = enc_caps(T, lanes)
        enc = encode_grouped_cuda(tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm)
        self.caps = dict(capw=enc[0].shape[1], capm=enc[1].shape[1])
        self.words = cs.front_packed(torch, enc[0], enc[3])
        self.mant = cs.front_packed(torch, enc[1], enc[4])
        self.states = enc[2]
        self.ptr0 = torch.zeros((2, lanes // 128), dtype=torch.int32, device=tokp.device)
        self.rows_a, self.rows_b = rows[:t_a].contiguous(), rows[t_a:].contiguous()

    def encode(self, torch, lib):
        return encode_launch(torch, lib, self.tokp, self.mantp, self.rows, T=self.T, lanes=self.lanes, **self.caps)

    def decode(self, torch, lib):
        """Both phases, joined by the carry, through B1's entry."""
        kw = dict(lanes=self.lanes, B=1)
        va, st, p = decode_launch(torch, lib, "jxl_rans_decode", self.words, self.mant, self.states, self.rows_a,
                                  self.ptr0, T=self.t_a, **kw)
        vb, st2, p2 = decode_launch(torch, lib, "jxl_rans_decode", self.words, self.mant, st.reshape(self.lanes),
                                    self.rows_b, p, T=self.T - self.t_a, **kw)
        return va, st, p, vb, st2, p2


def streams(torch, dev):
    """The bench image's d=1 stream and the three d = 0 streams of
    chip_smoke.py phase 3c."""
    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.codec.encode import _step_ctx_v8, entropy_inputs, pick_lanes, tokens_from_rgb
    from jxl_tpu_torch.codec.layout import lossless_layout, padded_layout, token_layout
    from jxl_tpu_torch.codec.lossless import ll_step_ctx, lossless_tokens
    from jxl_tpu_torch.core.io import read_png_rgb8

    img = synth_kodak()  # the bench image (bench.py:synth_kodak, 512x768, seed 0)
    h, w = img.shape[:2]
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], 256)
    lay = padded_layout(h, w, lanes)
    token, _nb, mant, _p, q_sorted, _v = tokens_from_rgb(torch.from_numpy(img).to(dev), 1.0, height=h, width=w, effort=7)
    tokp, mantp, rows, _f = entropy_inputs(token, mant, _step_ctx_v8(lay, q_sorted), lay, lanes)
    out = [Stream(torch, "bench d=1", tokp, mantp, rows, lay["T"], lay["t_a"], lanes)]
    noise = np.random.default_rng(0).integers(0, 256, img.shape, dtype=np.uint8)
    for name, im in (("bench", img), ("synth02", read_png_rgb8(cs.SYNTH02)), ("noise", noise)):
        hh, ww = im.shape[:2]
        ll_lanes = pick_lanes(3 * hh * ww, 256)
        llay = lossless_layout(hh, ww, ll_lanes)
        tok_l, _nb, mant_l, _p, qs_l = lossless_tokens(torch.from_numpy(im).to(dev), height=hh, width=ww, distance=0.0)
        tokp_l, mantp_l, rows_l, _f = entropy_inputs(tok_l, mant_l, ll_step_ctx(llay, qs_l), llay, ll_lanes)
        out.append(Stream(torch, f"{name} d=0", tokp_l, mantp_l, rows_l, llay["T"], llay["t_a"], ll_lanes))
    return img, out


def grid_calls(torch, dev, img, dists):
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
    return calls


def batched(torch, lib, calls, nb):
    """B2 through `lib` on the first nb streams of each captured launch."""
    out = []
    for (words, mant, states, rows, ptrs), T, lanes in calls:
        G = lanes // 128
        out += decode_launch(torch, lib, "jxl_rans_decode_batched", words[: nb * G].contiguous(),
                             mant[: nb * G].contiguous(), states[:nb].contiguous(), rows[:, :nb].contiguous(),
                             ptrs[:, : nb * G].contiguous(), T=T, lanes=lanes, B=nb)
    return out


def turns(torch, label, old_fn, new_fn):
    """old, new, new, old: CUDA-event means of 20 launches each."""
    o1, n1, n2, o2 = (cs.cuda_ms(torch, f, 20) for f in (old_fn, new_fn, new_fn, old_fn))
    mhz = cs.smi_sample()["mhz"]
    print(f"[A/B {label}] old {o1:.3f} ms, new {n1:.3f} ms, new {n2:.3f} ms, old {o2:.3f} ms "
          f"({(o1 + o2) / (n1 + n2):.2f}x; SM {mhz:.0f} MHz after)", flush=True)


def same(torch, label, a, b):
    torch.cuda.synchronize()
    if cs.max_abs_diff(zip(a, b)) != 0:
        raise AssertionError(f"{label}: the two versions' outputs differ")


def step_clock(torch, lib_new, lib_clk, s):
    """The clocked copy on stream s: cycles per step of each part."""
    same(torch, f"step clock {s.label}", s.decode(torch, lib_clk), s.decode(torch, lib_new))
    fn = lib_clk.jxl_step_clock
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    if fn(None, 1) != 0:
        raise RuntimeError("step clock reset failed")
    s.decode(torch, lib_clk)
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 8)()
    if fn(ctypes.addressof(out), 0) != 0:
        raise RuntimeError("step clock read failed")
    steps = s.T * (s.lanes // 128)  # summed over the groups' CTAs
    total, parts = out[0] / steps, [v / steps for v in out[1:]]
    ms_clk = cs.cuda_ms(torch, lambda: s.decode(torch, lib_clk), 20)
    ms = cs.cuda_ms(torch, lambda: s.decode(torch, lib_new), 20)
    mhz = cs.smi_sample()["mhz"]
    print(
        f"[step clock {s.label}] SM cycles per step of the state warp, T {s.T}: "
        + ", ".join(f"{name} {v:.1f}" for name, v in zip(PARTS, parts))
        + f", rest of the chunk loop {total - sum(parts):.1f}; loop {total:.1f} in all. Clocked copy {ms_clk:.3f} ms, "
        f"kernel {ms:.3f} ms ({ms * mhz * 1e3 / s.T:.0f} cycles a step at SM {mhz:.0f} MHz)", flush=True
    )


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", metavar="DIR", help="another version's jxl_tpu_torch/csrc, timed in turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rans_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}", flush=True)

    from jxl_tpu_torch.cuda_build import CSRC

    jobs = {"clocked": (clocked_source((CSRC / "rans_dec.cu").read_text()), "rans_dec_clocked")}
    for name in ("rans_dec", "rans_enc"):
        jobs[f"new {name}"] = ((CSRC / f"{name}.cu").read_text(), name)
        if args.parent_csrc:
            jobs[f"old {name}"] = ((Path(args.parent_csrc) / f"{name}.cu").read_text(), f"parent_{name}")
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(lambda j: build_lib(*j), jobs.values())))

    img, ss = streams(torch, dev)
    step_clock(torch, libs["new rans_dec"], libs["clocked"], ss[0])
    if not args.parent_csrc:
        return 0

    new_d, new_e, old_d, old_e = (libs[k] for k in ("new rans_dec", "new rans_enc", "old rans_dec", "old rans_enc"))
    for s in ss:
        same(torch, f"{s.label} B3", s.encode(torch, old_e), s.encode(torch, new_e))
        same(torch, f"{s.label} B1", s.decode(torch, old_d), s.decode(torch, new_d))
        turns(torch, f"{s.label} B3", lambda: s.encode(torch, old_e), lambda: s.encode(torch, new_e))
        turns(torch, f"{s.label} B1 (A + B)", lambda: s.decode(torch, old_d), lambda: s.decode(torch, new_d))
    for B, dists in ((10, cs.RUST_DISTANCES), (cs.GRID_BATCH, tuple(float(d) for d in np.linspace(0.5, 14.0, cs.GRID_BATCH)))):
        calls = grid_calls(torch, dev, img, dists)
        nbs = (1, 4, 10, 16, 32) if B == cs.GRID_BATCH else (B,)
        for nb in nbs:
            same(torch, f"B2 B={nb}", batched(torch, old_d, calls, nb), batched(torch, new_d, calls, nb))
            turns(torch, f"B2 row of {B}, first {nb} streams (A + B)", lambda: batched(torch, old_d, calls, nb),
                  lambda: batched(torch, new_d, calls, nb))
    return 0


if __name__ == "__main__":
    sys.exit(main())
