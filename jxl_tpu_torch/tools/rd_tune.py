"""A/B harness for codec tuning parameters on the RD objective (port of
`tools/rd_tune.py`).

Runs `python -m jxl_tpu_torch.tools.rd_point` in a subprocess per variant
(each variant's JXL_TPU_* settings go into that process's environment),
then reports each variant's interpolated bpp at the PSNR anchors (bpp at
38 dB on the bench image, at 40 dB on the corpus images) and every point.

Usage:
  python -m jxl_tpu_torch.tools.rd_tune base                      # baseline only
  python -m jxl_tpu_torch.tools.rd_tune base 'JXL_TPU_RDO_KAPPA=0.2' \\
      'JXL_TPU_FREQ_STRENGTH=1.5 JXL_TPU_CHAN_BASE=0.009,0.011,0.019' --device cuda:0
"""

import json
import os
import subprocess
import sys

import numpy as np

from jxl_tpu_torch.tools import REPO, parse, parser


def run_variant(env_str: str, device: str):
    env = dict(os.environ)
    for kv in env_str.split():
        if kv and kv != "base":
            k, v = kv.split("=", 1)
            env[k] = v
    p = subprocess.run(
        [sys.executable, "-m", "jxl_tpu_torch.tools.rd_point", "--device", device],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=1800,
    )
    if p.returncode != 0:
        print(p.stdout[-2000:], file=sys.stderr)
        print(p.stderr[-2000:], file=sys.stderr)
        raise RuntimeError(f"variant failed: {env_str}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def bpp_at(pts, target_psnr):
    """log-bpp interpolation of the sweep at a PSNR anchor."""
    pts = sorted(pts, key=lambda p: p[2])
    ps = np.array([p[2] for p in pts])
    bs = np.log(np.array([p[1] for p in pts]))
    if target_psnr < ps[0] or target_psnr > ps[-1]:
        return float("nan")
    return float(np.exp(np.interp(target_psnr, ps, bs)))


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("variants", nargs="*", help="'base' or space-separated KEY=VALUE settings")
    args = parse(ap, argv)
    variants = args.variants or ["base"]
    anchors = {"bench": 38.0, "synth0": 40.0, "synth1": 40.0, "synth2": 40.0}
    results = {}
    for v in variants:
        res = run_variant(v, args.device)
        results[v] = res
        cells = []
        for name, tgt in anchors.items():
            if name in res:
                cells.append(f"{name}@{tgt}dB={bpp_at(res[name], tgt):.4f}")
        print(f"{v or 'base'}: " + "  ".join(cells), flush=True)
        for name, pts in res.items():
            print(f"    {name}: " + " ".join(f"d{d}:{b:.3f}bpp/{p:.2f}dB" for d, b, p in pts))
    return results


if __name__ == "__main__":
    main()
