"""Modular-lossy calibration study (port of `tools/modular_calib.py`).

Collects, for every corpus image (`rd_position_corpus.FAMILY`) and a
distance grid, both coding paths' measured (bytes, PSNR, SSE):

  - VarDCT  (`encode_image_grid_async` with `CodecConfig(modular=False)`)
  - modular (`codec/lossless.py` with `modular_steps(d)` quantization,
    `encode._modular_grid_async`)

and which path the shipped dominance rule (the `_pick_mode` constants,
JXL_TPU_MOD_RULE) selects, plus whether the host pre-screen
(`_modular_candidate`, JXL_TPU_MODULAR) would have tried the modular path
at all. (The reference set JXL_TPU_MODULAR=0 for its VarDCT arm before
computing the screen, so its `candidate` column always read false; here
the VarDCT arm is pinned through the config and the screen runs as the
encoder runs it.) Prints one JSON row per point and writes them to
benchmarks/tools/modular_calib/modular_calib.json (or the path given).

Usage: python -m jxl_tpu_torch.tools.modular_calib [out.json] [--device cuda:0]
"""

import json
import os

import numpy as np

from jxl_tpu_torch.tools import default_out, parse, parser, read_corpus
from jxl_tpu_torch.tools.rd_position_corpus import FAMILY, psnr

DISTANCES = (0.5, 0.7, 1.0, 1.4, 2.0, 3.0, 5.0)
OUT = default_out("modular_calib", "modular_calib.json")


def sse(a, b) -> float:
    return float(np.sum((np.asarray(a).astype(np.float64) - np.asarray(b).astype(np.float64)) ** 2))


def calib_rows(images: dict, dists, dev) -> list:
    """One dict per image and distance (see the module docstring)."""
    import torch

    from jxl_tpu_torch.codec import encode
    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes

    knobs = encode.encoder_knobs()
    byte_win, sse_tol, sse_win, byte_tol = knobs.mod_rule
    rows = []
    for name, rgb in images.items():
        n_px = rgb.shape[0] * rgb.shape[1]
        cfg = CodecConfig(distance=1.0, effort=7)
        var_fin = encode.encode_image_grid_async(rgb, CodecConfig(distance=1.0, effort=7, modular=False), list(dists), device=dev)
        rgb_t = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
        mod_fin = encode._modular_grid_async(rgb_t, cfg, list(dists), "", knobs)
        var_datas, mod_datas = var_fin(), mod_fin()
        candidate = bool(encode._modular_candidate(rgb, knobs.modular))
        for i, d in enumerate(dists):
            rec_v = decode_bytes(var_datas[i], device=dev)
            rec_m = decode_bytes(mod_datas[i], device=dev)
            r = dict(
                name=name, family=FAMILY.get(name, "?"), d=d,
                var_bytes=len(var_datas[i]), var_psnr=psnr(rgb, rec_v), var_sse=sse(rec_v, rgb),
                mod_bytes=len(mod_datas[i]), mod_psnr=psnr(rgb, rec_m), mod_sse=sse(rec_m, rgb),
                n_px=n_px, candidate=candidate,
            )
            rv, rm, sv, sm = r["var_bytes"], r["mod_bytes"], r["var_sse"], r["mod_sse"]
            r["pick_modular"] = bool(
                (rm <= rv and sm <= sv)
                or (rm <= byte_win * rv and sm <= sse_tol * sv)
                or (sm <= sse_win * sv and rm <= byte_tol * rv)
            )
            rows.append(r)
            print(json.dumps(r), flush=True)
    return rows


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("out", nargs="?", default=OUT)
    args = parse(ap, argv)
    rows = calib_rows(read_corpus(sorted(FAMILY)), DISTANCES, args.dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print("wrote", args.out)
    return rows


if __name__ == "__main__":
    main()
