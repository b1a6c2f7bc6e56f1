"""Corpus-wide RD position report (port of `tools/rd_position_corpus.py`):
for every committed corpus image (test_images/synth), the codec's bpp at
its flagship (d=1) PSNR against the image's own Gaussian water-filling
bound (`rd_bound`) and same-PSNR WebP / JPEG anchors (PIL), plus
per-family geometric means.

`FAMILY`, `DISTANCES`, `psnr`, `anchor_bpp_curve` and `interp_bpp` are the
reference's, copied. Prints one JSON row per image and writes the table to
benchmarks/tools/rd_position_corpus/rd_position.md (or --out), headed by
the device it ran on.

Usage: python -m jxl_tpu_torch.tools.rd_position_corpus [--device cuda:0] [--out PATH]
"""

import io
import json

import numpy as np

from jxl_tpu_torch.tools import card_line, default_out, parse, parser, read_corpus, write_text

FAMILY = {
    "synth00": "photo", "synth01": "photo", "synth04": "photo", "synth05": "photo",
    "synth02": "graphics", "synth06": "graphics",
    "synth03": "portrait", "synth07": "portrait",
    "synth08": "text", "synth11": "text",
    "synth09": "diagonal", "synth10": "sky",
}

DISTANCES = (0.5, 0.7, 1.0, 1.4, 2.0)
OUT = default_out("rd_position_corpus", "rd_position.md")


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0**2 / max(mse, 1e-9))


def anchor_bpp_curve(rgb, fmt, qualities, **kw):
    """[(bpp, psnr)] for a PIL codec's quality ladder."""
    from PIL import Image

    im = Image.fromarray(rgb)
    n_px = rgb.shape[0] * rgb.shape[1]
    pts = []
    for q in qualities:
        buf = io.BytesIO()
        im.save(buf, fmt, quality=q, **kw)
        buf.seek(0)
        dec = np.asarray(Image.open(buf).convert("RGB"))
        pts.append((buf.getbuffer().nbytes * 8 / n_px, psnr(rgb, dec)))
    return pts


def interp_bpp(pts, target):
    """log-bpp interpolation at a PSNR target; nan outside the range."""
    pts = sorted(pts, key=lambda p: p[1])
    ps = np.array([p[1] for p in pts])
    bs = np.log([max(p[0], 1e-9) for p in pts])
    if not (ps[0] <= target <= ps[-1]):
        return float("nan")
    return float(np.exp(np.interp(target, ps, bs)))


def position_rows(images: dict, dev) -> list:
    """One dict per image (name -> RGB u8; family from FAMILY, "?" if not
    listed): name, family, target (d=1 PSNR), codec / bound / jpeg / webp
    bpp at that PSNR."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes, decode_bytes_grid_stacked
    from jxl_tpu_torch.codec.encode import encode_image_grid
    from jxl_tpu_torch.tools.rd_bound import bound_bpp, coeff_vars

    rows = []
    for name, rgb in images.items():
        n_px = rgb.shape[0] * rgb.shape[1]
        cfg = CodecConfig(distance=1.0, effort=7)
        datas = encode_image_grid(rgb, cfg, list(DISTANCES), device=dev)
        stacked = decode_bytes_grid_stacked(datas, device=dev)
        if stacked is not None:
            outs = stacked.cpu().numpy()
        else:
            outs = np.stack([decode_bytes(d, device=dev) for d in datas])
        codec_pts = [(len(d) * 8 / n_px, psnr(rgb, outs[i])) for i, d in enumerate(datas)]
        target = codec_pts[DISTANCES.index(1.0)][1]  # flagship PSNR
        codec_bpp = codec_pts[DISTANCES.index(1.0)][0]

        v8, n8 = coeff_vars(rgb, 8)
        bound = bound_bpp(v8, n8, target)
        jpeg = interp_bpp(anchor_bpp_curve(rgb, "JPEG", (60, 70, 80, 85, 90, 92, 95, 97)), target)
        webp = interp_bpp(anchor_bpp_curve(rgb, "WEBP", (50, 60, 70, 80, 85, 90, 93, 95, 98), method=6), target)
        rows.append(dict(
            name=name, family=FAMILY.get(name, "?"), target=target, codec=codec_bpp, bound=bound, jpeg=jpeg, webp=webp,
        ))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def gmean(vals):
    vals = [v for v in vals if np.isfinite(v)]
    return float(np.exp(np.mean(np.log(vals)))) if vals else float("nan")


def report(rows: list, card: str) -> str:
    lines = [
        f"# Corpus-wide RD position: {card}",
        "",
        "Generated by `python -m jxl_tpu_torch.tools.rd_position_corpus`: for each",
        "corpus image, this codec's bpp at its own d=1 e7 operating point against",
        "the image's Gaussian reverse-water-filling bound (`rd_bound`;",
        "approximate: for non-Gaussian content the true bound is lower) and WebP",
        "(method=6) / JPEG anchors log-interpolated to the same PSNR. `nan`",
        "anchors mean the anchor's quality ladder cannot reach that PSNR.",
        "",
        "| image | family | PSNR (dB) | codec bpp | bound bpp | codec/bound | WebP bpp | codec/WebP | JPEG bpp | codec/JPEG |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        cw = r["codec"] / r["webp"] if np.isfinite(r["webp"]) else float("nan")
        cj = r["codec"] / r["jpeg"] if np.isfinite(r["jpeg"]) else float("nan")
        lines.append(
            f"| {r['name']} | {r['family']} | {r['target']:.2f} | "
            f"{r['codec']:.4f} | {r['bound']:.4f} | "
            f"{r['codec'] / max(r['bound'], 1e-9):.2f} | "
            f"{r['webp']:.4f} | {cw:.2f} | {r['jpeg']:.4f} | {cj:.2f} |"
        )
    lines += ["", "| family | codec/bound | codec/WebP | codec/JPEG | n |", "|---|---|---|---|---|"]
    for fam in sorted({r["family"] for r in rows}) + ["ALL"]:
        sel = [r for r in rows if fam == "ALL" or r["family"] == fam]
        rb = gmean([r["codec"] / r["bound"] for r in sel])
        rw = gmean([r["codec"] / r["webp"] for r in sel if np.isfinite(r["webp"])])
        rj = gmean([r["codec"] / r["jpeg"] for r in sel if np.isfinite(r["jpeg"])])
        lines.append(f"| {fam} | {rb:.2f} | {rw:.2f} | {rj:.2f} | {len(sel)} |")
    lines += [
        "",
        "Ratios are geometric means; codec/X < 1 means this codec needs fewer",
        "bits than X at the same PSNR on that content. codec/bound < 1 on sharp",
        "families means the Gaussian bound is loose there (their coefficients",
        "are far from Gaussian), not that the codec beats information theory.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--out", default=OUT)
    args = parse(ap, argv)
    rows = position_rows(read_corpus(sorted(FAMILY)), args.dev)
    write_text(args.out, report(rows, card_line(args.dev)))
    return rows


if __name__ == "__main__":
    main()
