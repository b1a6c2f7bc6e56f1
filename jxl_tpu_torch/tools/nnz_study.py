"""Estimate the rate win of nnz-bucket-conditioned AC contexts before
building them (port of `tools/nnz_study.py`): tokenizes images with the
current encoder (`codec.analysis.encode_tokens_for_analysis`), rebuilds
the per-(channel, block) nonzero counts and compares

  (a) position-only contexts:  H(token | channel, band)
  (b) bucket-conditioned:      H(token | channel, band, nnz bucket)

plus the cost of signalling the bucket map (raw entropy and causal-
residual entropy) for several bucket edge sets. All entropies are ideal-
code bits of exact token histograms. `study_tokens` and `entropy_bits`
serve `ctx_study` and `combo_study` too. (The reference studies take the
AC span to start right after the DC section, which predates the nnz-map
section of the v8 layout; here it starts where the layout puts it.)

Usage: python -m jxl_tpu_torch.tools.nnz_study [--device cuda:0]
"""

import json
import os

import numpy as np

from jxl_tpu_torch.tools import CORPUS_DIR, parse, parser


def entropy_bits(counts: np.ndarray) -> float:
    """Ideal-code bits to send symbols with these counts (own table)."""
    c = counts[counts > 0].astype(np.float64)
    n = c.sum()
    if n == 0:
        return 0.0
    return float(n * np.log2(n) - (c * np.log2(c)).sum())


def study_tokens(rgb: np.ndarray, distance: float, effort: int, dev) -> dict:
    """The encoder's stream of rgb as numpy: token, nbits, values (all
    sections), the AC tokens ac_tok and signed values ac_val [3, 63, nb]
    (z-major), nnz [3, nb], the band table [63] and the token layout."""
    import torch

    from jxl_tpu_torch.codec.analysis import encode_tokens_for_analysis
    from jxl_tpu_torch.codec.layout import ac_band_table, token_layout
    from jxl_tpu_torch.entropy.tokens import detokenize, zigzag_unmap

    h, w = rgb.shape[:2]
    lay = token_layout(h, w)
    token, nbits, mant, _params, _q = encode_tokens_for_analysis(
        rgb, float(distance), height=h, width=w, effort=effort, device=dev
    )
    values = detokenize(token, mant)
    nb = lay["nb"]
    ac_start = lay["n_tokens"] - lay["n_ac"]  # after the nnz and DC sections
    ac_val = zigzag_unmap(values[ac_start:]).reshape(3, 63, nb)
    token = token.cpu().numpy()
    return {
        "lay": lay, "token": token, "nbits": nbits.cpu().numpy(), "values": values.cpu().numpy(),
        "ac_tok": token[ac_start:].reshape(3, 63, nb), "ac_val": ac_val.cpu().numpy(),
        "nnz": torch.sum(ac_val != 0, dim=1).cpu().numpy(), "band": np.asarray(ac_band_table()),
    }


def causal_residual_bits(q: np.ndarray, nby: int, nbx: int) -> float:
    """Ideal bits of a per-channel block map q [3, nb] sent as zigzagged
    residuals of its left (top, in the first column) neighbour."""
    s = 0.0
    for c in range(3):
        v = q[c].reshape(nby, nbx).astype(np.int64)
        left = np.pad(v, ((0, 0), (1, 0)))[:, :-1]
        up = np.pad(v, ((1, 0), (0, 0)))[:-1, :]
        pred = left.copy()
        pred[:, 0] = up[:, 0]
        res = v - pred
        zz = np.where(res >= 0, 2 * res, -2 * res - 1)
        s += entropy_bits(np.bincount(zz.reshape(-1)))
    return s


def study_image(name, rgb, distance, dev, effort=7):
    from jxl_tpu_torch.codec.layout import N_BANDS

    st = study_tokens(rgb, distance, effort, dev)
    lay, token, ac_tok, nnz, band = st["lay"], st["token"], st["ac_tok"], st["nnz"], st["band"]
    # mantissa bits ride outside the entropy coder; identical in both
    # schemes, so excluded from the comparison
    A = int(token.max()) + 1

    bits_now = 0.0
    for c in range(3):
        for b in range(N_BANDS):
            sel = ac_tok[c][band == b].reshape(-1)
            bits_now += entropy_bits(np.bincount(sel, minlength=A))

    out = {
        "image": name,
        "d": distance,
        "ac_bits_now": bits_now,
        "nnz_hist": np.bincount(nnz.reshape(-1), minlength=64)[:24].tolist(),
        "frac_empty_cb": float((nnz == 0).mean()),
        "buckets": {},
    }
    edge_sets = {
        "4@0,1,3,8": [1, 3, 8],
        "6@0,1,2,4,8,16": [1, 2, 4, 8, 16],
        "8@0,1,2,3,5,8,13,24": [1, 2, 3, 5, 8, 13, 24],
    }
    for label, edges in edge_sets.items():
        q = np.zeros_like(nnz)
        for e in edges:
            q += (nnz >= e).astype(nnz.dtype)
        Q = len(edges) + 1
        bits_cond = 0.0
        for c in range(3):
            for b in range(N_BANDS):
                toks_b = ac_tok[c][band == b]  # [bs, nb]
                for qq in range(Q):
                    sel = toks_b[:, q[c] == qq].reshape(-1)
                    bits_cond += entropy_bits(np.bincount(sel, minlength=A))
        sig_raw = sum(entropy_bits(np.bincount(q[c], minlength=Q)) for c in range(3))
        sig_res = causal_residual_bits(q, lay["nby"], lay["nbx"])
        out["buckets"][label] = {
            "ac_bits_cond": bits_cond,
            "sig_bits_raw": sig_raw,
            "sig_bits_res": sig_res,
            "net_saving_bits": bits_now - bits_cond - min(sig_raw, sig_res),
            "net_saving_pct_of_ac": 100.0 * (bits_now - bits_cond - min(sig_raw, sig_res)) / max(bits_now, 1.0),
        }
    return out


def summary(r: dict) -> dict:
    """The printed line of one study_image result."""
    return {
        "image": r["image"],
        "d": r["d"],
        "ac_bits_now": round(r["ac_bits_now"]),
        "frac_empty_cb": round(r["frac_empty_cb"], 3),
        "net_saving_pct_of_ac": {k: round(v["net_saving_pct_of_ac"], 2) for k, v in r["buckets"].items()},
        "sig_res_bits": {k: round(v["sig_bits_res"]) for k, v in r["buckets"].items()},
    }


def main(argv=None):
    args = parse(parser(__doc__), argv)

    from jxl_tpu_torch.bench.headline import synth_kodak
    from jxl_tpu_torch.core.io import read_image

    images = {"bench": synth_kodak()}
    if os.path.isdir(CORPUS_DIR):
        for f in sorted(os.listdir(CORPUS_DIR))[:4]:
            if f.endswith(".png"):
                images[f] = read_image(str(CORPUS_DIR / f))
    out = []
    for name, rgb in images.items():
        for d in (0.5, 1.0, 3.0):
            out.append(summary(study_image(name, rgb, d, args.dev)))
            print(json.dumps(out[-1]))
    return out


if __name__ == "__main__":
    main()
