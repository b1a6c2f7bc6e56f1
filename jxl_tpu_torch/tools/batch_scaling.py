"""Batch-scaling curve on one device (port of `tools/batch_scaling.py`):
encode and decode MP/s of the bench image at grid batch B in
{1, 2, 4, 8, 16, 32} (points of one image over distances
d = 1 + 1e-4 * i), where the per-row fixed cost stops amortizing.

Encode: steady-state cadence at pipeline depth 2 over
`encode_image_grid_async` rows, the priming dispatch and the last finalize
inside the window. Decode: the same over `decode_bytes_grid_stacked` (B2)
rows, or `decode_bytes_device` (B1) at B = 1, each waited for after the
next one is dispatched. max(3, 48 // B) rows a point.

Writes benchmarks/tools/batch_scaling/batch_scaling.md (or --out) with the
card's name and power limit, and prints the rows.

Usage: python -m jxl_tpu_torch.tools.batch_scaling [--device cuda:0] [--out PATH]
"""

from __future__ import annotations

import time

import numpy as np

from jxl_tpu_torch.tools import card_line, default_out, parse, parser, sync, write_text

BATCHES = (1, 2, 4, 8, 16, 32)
OUT = default_out("batch_scaling", "batch_scaling.md")


def scaling_rows(img: np.ndarray, dev, batches=BATCHES, iters=None) -> list:
    """[(B, enc MP/s, dec MP/s, combined MP/s)] per batch size; `iters`
    rows per point (default max(3, 48 // B))."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes_device, decode_bytes_grid_stacked
    from jxl_tpu_torch.codec.encode import encode_image_grid, encode_image_grid_async

    h, w = img.shape[:2]
    mp = h * w / 1e6
    cfg = CodecConfig(distance=1.0, effort=7)
    rows = []
    for B in batches:
        dists = [1.0 + 1e-4 * i for i in range(B)]  # distinct values, as in the reference
        datas = encode_image_grid(img, cfg, dists, device=dev)  # warm
        n = iters or max(3, 48 // B)
        sync(dev)
        t0 = time.perf_counter()
        fin = encode_image_grid_async(img, cfg, dists, device=dev)
        for _ in range(n - 1):
            nxt = encode_image_grid_async(img, cfg, dists, device=dev)
            datas = fin()
            fin = nxt
        datas = fin()
        sync(dev)
        t_enc = (time.perf_counter() - t0) / (n * B)

        if B == 1:
            def dec():
                return decode_bytes_device(datas[0], device=dev)
        else:
            def dec():
                return decode_bytes_grid_stacked(datas, device=dev)
        dec()  # warm
        sync(dev)
        t0 = time.perf_counter()
        dec()
        for _ in range(n - 1):
            dec()
            sync(dev)
        sync(dev)
        t_dec = (time.perf_counter() - t0) / (n * B)
        rows.append((B, mp / t_enc, mp / t_dec, mp / (t_enc + t_dec)))
        print(rows[-1], flush=True)
    return rows


def report(rows: list, card: str, h: int, w: int) -> str:
    base = rows[0]
    lines = [
        f"# Batch-scaling curve: {card}",
        "",
        "Generated by `python -m jxl_tpu_torch.tools.batch_scaling`: the same",
        f"{h}x{w} d=1 e7 encode+decode measured at grid batch sizes",
        f"{', '.join(str(r[0]) for r in rows)} (points per row, steady-state cadence at",
        "pipeline depth 2, the priming row and the last finalize inside the",
        "window). Efficiency = per-image throughput against linear scaling of",
        "the batch-1 point.",
        "",
        "| batch | enc MP/s | dec MP/s | combined MP/s | eff vs B=1 |",
        "|---|---|---|---|---|",
    ]
    for B, e, d, c in rows:
        lines.append(f"| {B} | {e:.2f} | {d:.2f} | {c:.2f} | {c / base[3]:.2f}x |")
    best = max(rows, key=lambda r: r[3])
    lines += ["", f"Knee: combined throughput peaks at batch {best[0]} ({best[3]:.2f} MP/s)."]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--out", default=OUT)
    args = parse(ap, argv)

    from jxl_tpu_torch.bench.headline import synth_kodak

    img = synth_kodak()
    rows = scaling_rows(img, args.dev)
    write_text(args.out, report(rows, card_line(args.dev), *img.shape[:2]))
    return rows


if __name__ == "__main__":
    main()
