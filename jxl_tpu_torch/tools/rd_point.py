"""Measure (bpp, PSNR) RD points of the current codec configuration (port
of `tools/rd_point.py`).

Encodes the bench image (`bench.headline.synth_kodak`) plus RD_CORPUS
(default 3) corpus-style synthetic images (`make_test_images.synth_photo`,
512x768, seeds 100...) over the RD_DISTANCES sweep (default
0.7,0.85,1.0,1.2,1.45) at effort RD_EFFORT (default 7), decodes, and prints
ONE JSON line: {image: [[d, bpp, psnr], ...]}. The port reads every
JXL_TPU_* knob on each encode, so `rd_tune` A/Bs settings through this
tool's environment.

Usage: python -m jxl_tpu_torch.tools.rd_point [--device cuda:0]
"""

import json
import os

import numpy as np

from jxl_tpu_torch.tools import parse, parser

DISTANCES = (0.7, 0.85, 1.0, 1.2, 1.45)  # the RD_DISTANCES default


def rd_points(images: dict, dists, effort: int, dev) -> dict:
    """{name: [[d, bpp, psnr], ...]}: each image through one grid encode
    over `dists` and the row decode (B2; per stream where the row is not
    uniform)."""
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes, decode_bytes_grid_stacked
    from jxl_tpu_torch.codec.encode import encode_image_grid

    cfg = CodecConfig(distance=1.0, effort=effort)
    out = {}
    for name, img in images.items():
        h, w = img.shape[:2]
        datas = encode_image_grid(img, cfg, dists, device=dev)
        dec = decode_bytes_grid_stacked(datas, device=dev)
        dec = dec.cpu().numpy() if dec is not None else np.stack([decode_bytes(d, device=dev) for d in datas])
        pts = []
        ref = img.astype(np.float64)
        for i, d in enumerate(dists):
            mse = ((dec[i].astype(np.float64) - ref) ** 2).mean()
            psnr = 10 * np.log10(255.0**2 / mse)
            pts.append([d, len(datas[i]) * 8 / (h * w), round(psnr, 4)])
        out[name] = pts
    return out


def main(argv=None):
    args = parse(parser(__doc__), argv)

    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.tools.make_test_images import synth_photo

    effort = int(os.environ.get("RD_EFFORT", "7"))
    dists = [float(s) for s in os.environ.get("RD_DISTANCES", ",".join(map(str, DISTANCES))).split(",")]
    n_corpus = int(os.environ.get("RD_CORPUS", "3"))

    images = {"bench": synth_kodak()}
    for i in range(n_corpus):
        images[f"synth{i}"] = synth_photo(512, 768, seed=100 + i)
    out = rd_points(images, dists, effort, args.dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
