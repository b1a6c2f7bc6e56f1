"""Information-theoretic R-D bound for an image + codec-position report
(port of `tools/rd_bound.py`).

PCA-decorrelate the RGB channels, take the per-coefficient variances of an
NxN DCT over the image, and compute the Gaussian reverse water-filling
bound
    R(D) = sum_i 0.5 * max(0, log2(sigma_i^2 / lambda)),
    D(lambda) = mean_i min(lambda, sigma_i^2)
(`dct_mat`, `coeff_vars`, `bound_bpp`, `anchor_bpp`: the reference's
numpy, copied). Prints the bound at 8x8, 16x16 and 32x32, JPEG / WebP (via
PIL) bpp at the same PSNR as anchors, and this codec's bpp there, log-
interpolated over `rd_point`'s default distances encoded on the device.

Usage: python -m jxl_tpu_torch.tools.rd_bound [image.png] [--psnr 38.0] [--device cuda:0]
       (no image -> the bench image, `bench.headline.synth_kodak`)
"""

import io
import os

import numpy as np

from jxl_tpu_torch.tools import parse, parser


def dct_mat(n):
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    m[0] *= 1 / np.sqrt(2)
    return m


def coeff_vars(rgb, n):
    """[3 * n^2] DCT-coefficient variances of the PCA-decorrelated image."""
    h, w, _ = rgb.shape
    h, w = h // n * n, w // n * n
    x = rgb[:h, :w].astype(np.float64)
    flat = x.reshape(-1, 3) - x.reshape(-1, 3).mean(0)
    _evals, evecs = np.linalg.eigh(flat.T @ flat / len(flat))
    y = (flat @ evecs).reshape(h, w, 3)
    d = dct_mat(n)
    out = []
    for c in range(3):
        b = y[:, :, c].reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)
        coef = np.einsum("ui,abiv->abuv", d, np.einsum("vj,abij->abiv", d, b))
        out.append(coef.reshape(-1, n * n).var(axis=0))
    return np.concatenate(out), n * n


def bound_bpp(variances, n2, target_psnr):
    target_mse = 255.0**2 * 10 ** (-target_psnr / 10)

    def rd(lam):
        d = np.minimum(lam, variances).mean()
        r = 0.5 * np.maximum(0, np.log2(variances / np.maximum(lam, 1e-12))).sum() / n2
        return d, r

    lo, hi = 1e-6, 1e6
    for _ in range(200):
        mid = np.sqrt(lo * hi)
        d, _ = rd(mid)
        if d > target_mse:
            hi = mid
        else:
            lo = mid
    return rd(np.sqrt(lo * hi))[1]


def anchor_bpp(rgb, fmt, target_psnr, qualities):
    """bpp of a PIL codec at target PSNR (log-interpolated)."""
    from PIL import Image

    im = Image.fromarray(rgb)
    n_px = rgb.shape[0] * rgb.shape[1]
    pts = []
    for q in qualities:
        buf = io.BytesIO()
        kw = {"method": 6} if fmt == "WEBP" else {}
        im.save(buf, fmt, quality=q, **kw)
        dec = np.asarray(Image.open(buf)).astype(np.float64)
        mse = ((dec - rgb.astype(np.float64)) ** 2).mean()
        pts.append((10 * np.log10(255.0**2 / mse), buf.tell() * 8 / n_px))
    pts.sort()
    ps = np.array([p for p, _ in pts])
    bs = np.log([b for _, b in pts])
    if not (ps[0] <= target_psnr <= ps[-1]):
        return float("nan")
    return float(np.exp(np.interp(target_psnr, ps, bs)))


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("image", nargs="?")
    ap.add_argument("--psnr", type=float, default=38.0)
    args = parse(ap, argv)

    if args.image:
        from jxl_tpu_torch.core.io import read_image

        rgb = read_image(args.image)
        name = os.path.basename(args.image)
    else:
        from jxl_tpu_torch.bench.headline import synth_kodak

        rgb = synth_kodak()
        name = "bench (synth_kodak 512x768)"

    from jxl_tpu_torch.tools.rd_point import DISTANCES, rd_points
    from jxl_tpu_torch.tools.rd_tune import bpp_at

    print(f"image: {name}  target PSNR {args.psnr} dB")
    for n in (8, 16, 32):
        v, n2 = coeff_vars(rgb, n)
        print(f"  Gaussian water-filling bound ({n}x{n} DCT): "
              f"{bound_bpp(v, n2, args.psnr):.4f} bpp")
    j = anchor_bpp(rgb, "JPEG", args.psnr, (60, 70, 80, 85, 90, 92, 95, 97))
    wq = anchor_bpp(rgb, "WEBP", args.psnr, (60, 70, 80, 85, 90, 93, 95, 98))
    print(f"  JPEG (PIL) @ {args.psnr} dB: {j:.4f} bpp")
    print(f"  WebP (libwebp m6) @ {args.psnr} dB: {wq:.4f} bpp")
    pts = rd_points({"img": rgb}, list(DISTANCES), 7, args.dev)["img"]
    print(f"  this codec (e7, {args.dev}) @ {args.psnr} dB: {bpp_at(pts, args.psnr):.4f} bpp")


if __name__ == "__main__":
    main()
