"""Pick the v8 context configuration (port of `tools/combo_study.py`):
ideal AC bits under combinations of position granularity x nnz-bucket
count, with signalling:

  b6   : channel x 6 bands                      (baseline)
  p63  : channel x 63 positions
  p63q2: channel x 63 positions x {empty, busy} block
  p63q4: channel x 63 positions x 4 nnz buckets (edges 1, 3, 8)
  b6q4 : channel x 6 bands x 4 buckets

Net numbers subtract the bucket-map signalling (causal residual entropy).

Usage: python -m jxl_tpu_torch.tools.combo_study [--device cuda:0]
"""

import json
import os

import numpy as np

from jxl_tpu_torch.tools import CORPUS_DIR, parse, parser
from jxl_tpu_torch.tools.nnz_study import causal_residual_bits, entropy_bits, study_tokens


def study(name, rgb, distance, dev, effort=7) -> dict:
    st = study_tokens(rgb, distance, effort, dev)
    lay, ac_tok, nnz, band = st["lay"], st["ac_tok"], st["nnz"], st["band"]
    A = 64

    def buckets(edges):
        q = np.zeros_like(nnz)
        for e in edges:
            q += (nnz >= e).astype(nnz.dtype)
        return q

    def cond_bits(pos_map, q, Q):
        bits = 0.0
        for c in range(3):
            for b in np.unique(pos_map):
                toks = ac_tok[c][pos_map == b]
                if Q == 1:
                    bits += entropy_bits(np.bincount(toks.reshape(-1), minlength=A))
                else:
                    for qq in range(Q):
                        sel = toks[:, q[c] == qq].reshape(-1)
                        bits += entropy_bits(np.bincount(sel, minlength=A))
        return bits

    def sig_bits(q):
        return causal_residual_bits(q, lay["nby"], lay["nbx"])

    pos = np.arange(63)
    q2 = buckets([1])
    q4 = buckets([1, 3, 8])
    base = cond_bits(band, None, 1)
    res = {"image": name, "d": distance, "ac_bits_b6": round(base)}
    for label, (pm, q, Q, sig) in {
        "p63": (pos, None, 1, 0.0),
        "p63q2": (pos, q2, 2, sig_bits(q2)),
        "p63q4": (pos, q4, 4, sig_bits(q4)),
        "b6q4": (band, q4, 4, sig_bits(q4)),
    }.items():
        bits = cond_bits(pm, q, Q) + sig
        res[label + "_net_pct"] = round(100 * (base - bits) / max(base, 1), 2)
    print(json.dumps(res))
    return res


def main(argv=None):
    args = parse(parser(__doc__), argv)

    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.core.io import read_image

    images = {"bench": synth_kodak()}
    for f in ("synth00.png", "synth02.png", "synth04.png", "synth06.png"):
        p = CORPUS_DIR / f
        if os.path.exists(p):
            images[f] = read_image(str(p))
    return [study(name, rgb, d, args.dev) for name, rgb in images.items() for d in (0.5, 1.0, 3.0)]


if __name__ == "__main__":
    main()
