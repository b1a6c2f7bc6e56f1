#!/usr/bin/env python3
"""Headline benchmark of the PyTorch + CUDA port (jxl_tpu_torch) on one
NVIDIA GPU: bench.py's stages and one-line JSON, on cuda:0.

    python3 bench_torch.py

Prints ONE JSON line: every key of bench.py's line (combined encode+decode
MP/s of the grid-batched paths at d=1 on the 512x768 bench image, the
single-image rates, spreads over JXL_BENCH_REPS trials, psnr_db, bpp, the
roofline block, whose device times are the traced rows' busy time), plus
`device` (the card's name and power limit), `launches` (each kernel's
launches over the run) and `trace` (busy time and idle share per image
from torch.profiler). The stages and
their definitions are in jxl_tpu_torch/bench/headline.py. bench.py's
environment knobs keep their meaning: JXL_BENCH_SIZE=HxW (a synthetic
image of that size), JXL_BENCH_BATCH (grid points per row, default 32),
JXL_BENCH_REPS (trials per median, default 5). Without a CUDA card it
raises and exits non-zero.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    from jxl_tpu_torch.bench.headline import headline, load_bench_image, synth_kodak

    size = os.environ.get("JXL_BENCH_SIZE")
    img = synth_kodak(*(int(v) for v in size.split("x"))) if size else load_bench_image()
    batch = int(os.environ.get("JXL_BENCH_BATCH", "32"))
    reps = int(os.environ.get("JXL_BENCH_REPS", "5"))
    print(json.dumps(headline(img, device="cuda:0", batch=batch, reps=reps)))


if __name__ == "__main__":
    main()
