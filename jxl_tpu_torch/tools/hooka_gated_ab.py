"""RD-gated Hook A corpus A/B (port of `tools/hooka_gated_ab.py`).

A/Bs the near-tie-gated homogeneity override (Strategy.HOMOGENEITY_RD_GATED,
`strategy/acs.py`, margin JXL_TPU_HOOKA_EPS) against BASELINE and the
thesis's unconditional HOMOGENEITY_PARTITIONING on the corpus
(`rd_position_corpus.FAMILY`) at d in {1, 3}, the VarDCT path isolated
(`CodecConfig(modular=False)`). Prints one JSON row per point and writes
the table to benchmarks/tools/hooka_gated_ab/hooka_gated.md (or --out).

Usage: python -m jxl_tpu_torch.tools.hooka_gated_ab [--out PATH] [--device cuda:0]
"""

import json

import numpy as np

from jxl_tpu_torch.tools import card_line, default_out, parse, parser, read_corpus, write_text
from jxl_tpu_torch.tools.rd_position_corpus import FAMILY, psnr

DISTANCES = (1.0, 3.0)
OUT = default_out("hooka_gated_ab", "hooka_gated.md")
ARMS = ("BASELINE", "HOMOGENEITY_PARTITIONING", "HOMOGENEITY_RD_GATED")


def ab_rows(images: dict, dists, dev) -> list:
    """One dict per image and distance: <arm>_bytes and <arm>_psnr per arm."""
    from jxl_tpu_torch.codec.config import CodecConfig, Strategy
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.encode import encode_image_grid

    rows = []
    for name, rgb in images.items():
        per = {}
        for arm in ARMS:
            cfg = CodecConfig(distance=1.0, effort=7, strategy=Strategy[arm], modular=False)
            datas = encode_image_grid(rgb, cfg, list(dists), device=dev)
            per[arm] = [(len(d), psnr(rgb, decode_bytes(d, device=dev))) for d in datas]
        for i, d in enumerate(dists):
            r = dict(name=name, family=FAMILY.get(name, "?"), d=d)
            for arm in ARMS:
                r[f"{arm}_bytes"], r[f"{arm}_psnr"] = per[arm][i]
            rows.append(r)
            print(json.dumps(r), flush=True)
    return rows


def report(rows: list, card: str) -> str:
    lines = [
        f"# RD-gated Hook A: corpus A/B ({card})",
        "",
        "`HOMOGENEITY_RD_GATED` applies the thesis's HomogeneityPartition",
        "override only where the partitioned candidate is within",
        "JXL_TPU_HOOKA_EPS (default 2%) of the dense argmin winner's proxy",
        "rate. VarDCT path isolated; deltas against BASELINE at equal d.",
        "",
        "| image | family | d | base bytes | base PSNR | HookA dB / dbytes | gated dB / dbytes |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['name']} | {r['family']} | {r['d']} | "
            f"{r['BASELINE_bytes']} | {r['BASELINE_psnr']:.3f} | "
            f"{r['HOMOGENEITY_PARTITIONING_psnr'] - r['BASELINE_psnr']:+.3f} / "
            f"{r['HOMOGENEITY_PARTITIONING_bytes'] - r['BASELINE_bytes']:+d} | "
            f"{r['HOMOGENEITY_RD_GATED_psnr'] - r['BASELINE_psnr']:+.3f} / "
            f"{r['HOMOGENEITY_RD_GATED_bytes'] - r['BASELINE_bytes']:+d} |"
        )

    def mean(k):
        return float(np.mean([r[k] for r in rows]))

    lines += [
        "",
        f"Corpus means: HookA {mean('HOMOGENEITY_PARTITIONING_psnr') - mean('BASELINE_psnr'):+.4f} dB "
        f"for {mean('HOMOGENEITY_PARTITIONING_bytes') - mean('BASELINE_bytes'):+.0f} B; "
        f"gated {mean('HOMOGENEITY_RD_GATED_psnr') - mean('BASELINE_psnr'):+.4f} dB "
        f"for {mean('HOMOGENEITY_RD_GATED_bytes') - mean('BASELINE_bytes'):+.0f} B.",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--out", default=OUT)
    args = parse(ap, argv)
    rows = ab_rows(read_corpus(sorted(FAMILY)), DISTANCES, args.dev)
    write_text(args.out, report(rows, card_line(args.dev)))
    return rows


if __name__ == "__main__":
    main()
