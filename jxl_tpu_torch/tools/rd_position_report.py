"""RD-position report of two codec builds on the bench image (port of
`tools/rd_position_report.py`): each build's measured RD curve against the
Gaussian water-filling bound and the JPEG / WebP anchors (`rd_bound`'s
maths, recomputed here on the host).

Inputs: two `rd_point` JSON files, the current build's and an earlier
one's. Writes benchmarks/tools/rd_position_report/rd_position.md (or
--out) first, then the figure rd_curve.png beside it, which needs
matplotlib: where it is missing (the card's machine) the table is written
and the figure refused with an error (`bench.plots.require_matplotlib`).
No device work runs here; `--device` is resolved like every tool's.

Usage: python -m jxl_tpu_torch.tools.rd_position_report cur.json prev.json [--device cuda:0] [--out PATH]
"""

import json
import os

import numpy as np

from jxl_tpu_torch.tools import default_out, parse, parser, write_text

# reference palette (validated categorical slots, fixed order)
C_CUR = "#2a78d6"  # slot 1 blue
C_PREV = "#eb6834"  # slot 2 orange
C_WEBP = "#1baf7a"  # slot 3 aqua
C_NEUTRAL = "#52514e"
C_GRID = "#e6e5e1"
TARGET = 38.0
OUT = default_out("rd_position_report", "rd_position.md")  # rd_curve.png beside it


def position(rgb: np.ndarray, cur: list, prev: list) -> dict:
    """Bounds, anchors and both curves' bpp at TARGET dB."""
    from jxl_tpu_torch.tools.rd_bound import anchor_bpp, bound_bpp, coeff_vars
    from jxl_tpu_torch.tools.rd_tune import bpp_at

    v8, n8 = coeff_vars(rgb, 8)
    v16, n16 = coeff_vars(rgb, 16)
    return {
        "bound8": bound_bpp(v8, n8, TARGET),
        "bound16": bound_bpp(v16, n16, TARGET),
        "jpeg": anchor_bpp(rgb, "JPEG", TARGET, (60, 70, 80, 85, 90, 92, 95, 97)),
        "webp": anchor_bpp(rgb, "WEBP", TARGET, (60, 70, 80, 85, 90, 93, 95, 98)),
        "cur": bpp_at(cur, TARGET),
        "prev": bpp_at(prev, TARGET),
        "bound_curve": [(p, bound_bpp(v8, n8, p)) for p in np.linspace(35.0, 41.5, 27)],
    }


def report(pos: dict, cur: list, prev: list, names) -> str:
    b8 = pos["bound8"]
    lines = [
        "# RD position: where the codec sits against its theoretical ceiling",
        "",
        "Generated by `python -m jxl_tpu_torch.tools.rd_position_report` from",
        f"`{names[0]}` (current) and `{names[1]}` (previous), `rd_point` JSON;",
        "bound and anchors: `rd_bound`'s maths on the bench image",
        "(`synth_kodak`, 512x768).",
        "",
        f"## Numbers (bench image @ {TARGET} dB PSNR)",
        "",
        f"| coder | bpp @ {TARGET} dB | vs 8x8 bound |",
        "|---|---|---|",
        f"| Gaussian water-filling bound, 8x8 DCT | {b8:.3f} | 1.00x |",
        f"| Gaussian water-filling bound, 16x16 DCT | {pos['bound16']:.3f} | {pos['bound16'] / b8:.2f}x |",
        f"| **this codec (current, e7)** | **{pos['cur']:.3f}** | **{pos['cur'] / b8:.2f}x** |",
        f"| this codec (previous, e7) | {pos['prev']:.3f} | {pos['prev'] / b8:.2f}x |",
        f"| WebP (libwebp, method 6) | {pos['webp']:.3f} | {pos['webp'] / b8:.2f}x |",
        f"| JPEG (PIL/libjpeg) | {pos['jpeg']:.3f} | {pos['jpeg'] / b8:.2f}x |",
        "",
        "![RD curves](rd_curve.png)",
        "",
        "## Full curves (bench image)",
        "",
        "| d | current bpp | current dB | previous bpp | previous dB |",
        "|---|---|---|---|---|",
    ]
    for (d, b1, p1), (_d, b0, p0) in zip(cur, prev):
        lines.append(f"| {d} | {b1:.4f} | {p1:.2f} | {b0:.4f} | {p0:.2f} |")
    return "\n".join(lines) + "\n"


def figure(pos: dict, cur: list, prev: list, out_png: str) -> None:
    from jxl_tpu_torch.bench.plots import _pyplot

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7.2, 4.6), dpi=150)
    fig.patch.set_facecolor("#fcfcfb")
    ax.set_facecolor("#fcfcfb")
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(C_GRID)
    ax.grid(True, color=C_GRID, linewidth=0.8)
    ax.set_axisbelow(True)
    ax.tick_params(colors=C_NEUTRAL, labelsize=9)
    psnrs = [p for p, _ in pos["bound_curve"]]
    bound = [b for _, b in pos["bound_curve"]]
    ax.plot(bound, psnrs, ls="--", lw=1.6, color=C_NEUTRAL, alpha=0.7, label="Gaussian R-D bound (8x8)")
    for pts, color, label in ((prev, C_PREV, "previous codec"), (cur, C_CUR, "current codec")):
        ax.plot([p[1] for p in pts], [p[2] for p in pts], "-o", color=color, lw=2, ms=4.5, label=label)
    ax.plot([pos["webp"]], [TARGET], "D", color=C_WEBP, ms=7, label=f"WebP m6 @{TARGET:g} dB")
    if np.isfinite(pos["jpeg"]):
        ax.plot([pos["jpeg"]], [TARGET], "s", color=C_NEUTRAL, ms=6, label=f"JPEG @{TARGET:g} dB")
    ax.legend(fontsize=8.5, frameon=False)
    ax.set_xlabel("bits per pixel", fontsize=10, color="#0b0b0b")
    ax.set_ylabel("PSNR (dB)", fontsize=10, color="#0b0b0b")
    ax.set_title("Bench image (synth_kodak 512x768), effort 7: RD position", fontsize=11, color="#0b0b0b", loc="left")
    fig.tight_layout()
    fig.savefig(out_png, facecolor=fig.get_facecolor())
    plt.close(fig)
    print("wrote", out_png)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("current", help="rd_point JSON of the current build")
    ap.add_argument("previous", help="rd_point JSON of the earlier build")
    ap.add_argument("--out", default=OUT)
    args = parse(ap, argv)

    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.bench.plots import require_matplotlib

    with open(args.current) as f:
        cur = json.load(f)["bench"]
    with open(args.previous) as f:
        prev = json.load(f)["bench"]
    pos = position(synth_kodak(), cur, prev)
    write_text(args.out, report(pos, cur, prev, (os.path.basename(args.current), os.path.basename(args.previous))))
    require_matplotlib("the RD figure")
    figure(pos, cur, prev, os.path.join(os.path.dirname(os.path.abspath(args.out)), "rd_curve.png"))
    return pos


if __name__ == "__main__":
    main()
