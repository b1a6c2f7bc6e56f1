"""Measure candidate rate levers on the current token streams (port of
`tools/ctx_study.py`).

For each image x distance, tokenizes with the current encoder and reports
ideal-code bits under:
  - bands6: current contexts (channel x 6 dyadic bands)      [baseline]
  - pos63:  per-zigzag-position contexts (channel x 63)       [finer static]
  - bands12: 12 finer dyadic-ish bands                        [middle]
  - mant_waste: raw bits lost to byte-aligned mantissas (all sections)
  - msb1/msb2: hybrid-uint with 1/2 mantissa MSBs folded into the token
    (alphabet grows; remaining raw bits byte-aligned vs bit-aligned)

Usage: python -m jxl_tpu_torch.tools.ctx_study [--device cuda:0]
"""

import json
import os

import numpy as np

from jxl_tpu_torch.tools import CORPUS_DIR, parse, parser
from jxl_tpu_torch.tools.nnz_study import entropy_bits, study_tokens


def study(name, rgb, distance, dev, effort=7) -> dict:
    st = study_tokens(rgb, distance, effort, dev)
    lay, token, nbits_np, values, ac_tok, band = (
        st["lay"], st["token"], st["nbits"], st["values"], st["ac_tok"], st["band"],
    )
    A = 64

    def ctx_bits(band_map):
        bits = 0.0
        for c in range(3):
            for b in np.unique(band_map):
                sel = ac_tok[c][band_map == b].reshape(-1)
                bits += entropy_bits(np.bincount(sel, minlength=A))
        return bits

    bands6 = ctx_bits(band)
    pos63 = ctx_bits(np.arange(63))
    # 12 bands: split each dyadic band in half by position
    edges12 = [2, 3, 4, 6, 8, 12, 16, 24, 32, 48]
    b12 = np.zeros(63, np.int32)
    pos = np.arange(1, 64)
    for e in edges12:
        b12 += (pos >= e).astype(np.int32)
    bands12 = ctx_bits(b12)

    # mantissa byte-align waste, whole stream
    nb_tok = nbits_np[nbits_np > 0]
    waste = int((8 * ((nb_tok + 7) // 8) - nb_tok).sum())

    # hybrid-uint variants over the whole stream (all sections), bits under
    # per-section contexts equal to the current ones (ctx id from layout)
    ctx_ids = np.asarray(lay["ctx"])

    def variant_bits(split, msb):
        v = values.astype(np.int64)
        big = v >= split
        blen = np.zeros_like(v)
        nz = v > 0
        blen[nz] = np.floor(np.log2(v[nz])).astype(np.int64) + 1
        exp = np.where(big, blen - 1, 0)
        keep = np.minimum(msb, np.maximum(exp, 0))
        rawbits = np.where(big, exp - keep, 0)
        msb_val = np.where(big, (v >> rawbits) - (1 << keep), 0)
        tok = np.where(big, split + (exp - 0) * (1 << msb) + msb_val, v)
        bits = 0.0
        for c in np.unique(ctx_ids):
            sel = tok[ctx_ids == c]
            bits += entropy_bits(np.bincount(sel, minlength=1))
        raw_bit_aligned = int(rawbits.sum())
        rb = rawbits[rawbits > 0]
        raw_byte_aligned = int((8 * ((rb + 7) // 8)).sum())
        return bits, raw_bit_aligned, raw_byte_aligned, int(tok.max()) + 1

    cur_tok_bits = 0.0
    for c in np.unique(ctx_ids):
        sel = token[ctx_ids == c]
        cur_tok_bits += entropy_bits(np.bincount(sel, minlength=A))
    cur_raw_byte = int((8 * ((nb_tok + 7) // 8)).sum())

    out = {"image": name, "d": distance, "bands6_ac": round(bands6)}
    out["gain_pos63_pct"] = round(100 * (bands6 - pos63) / max(bands6, 1), 2)
    out["gain_bands12_pct"] = round(100 * (bands6 - bands12) / max(bands6, 1), 2)
    out["mant_waste_bits"] = waste
    total_now = cur_tok_bits + cur_raw_byte
    for label, (split, msb) in {"msb1@32": (32, 1), "msb2@32": (32, 2), "msb2@16": (16, 2)}.items():
        tb, rbit, rbyte, alpha = variant_bits(split, msb)
        out[label] = {
            "alpha": alpha,
            "gain_bytealigned_pct": round(100 * (total_now - tb - rbyte) / total_now, 2),
            "gain_bitaligned_pct": round(100 * (total_now - tb - rbit) / total_now, 2),
        }
    out["total_now_bits"] = round(total_now)
    print(json.dumps(out))
    return out


def main(argv=None):
    args = parse(parser(__doc__), argv)

    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.core.io import read_image

    images = {"bench": synth_kodak()}
    for f in ("synth00.png", "synth02.png", "synth04.png"):
        p = CORPUS_DIR / f
        if os.path.exists(p):
            images[f] = read_image(str(p))
    return [study(name, rgb, d, args.dev) for name, rgb in images.items() for d in (1.0, 3.0)]


if __name__ == "__main__":
    main()
