"""Generate synthetic photographic-like test sets (port of
`tools/make_test_images.py`).

The six generators and `GENERATORS` are the reference's, copied: the
pixels equal its at every seed (tests/test_torch_tools.py). Files go
through the port's stdlib writer (`core.io.write_image`), so the PNG bytes
may differ from the reference's PIL-written ones while the pixels read
back equal. The default output is `benchmarks/tools/make_test_images/`,
not the tracked `test_images/`.

Usage: python -m jxl_tpu_torch.tools.make_test_images [--out DIR] [--n 12]
       [--size HxW] [--device cuda:0]
"""

import os

import numpy as np

from jxl_tpu_torch.tools import OUT_ROOT, parse, parser

OUT = str(OUT_ROOT / "make_test_images")  # synth/ under it


def synth_photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    # smooth multi-scale base
    base = np.zeros((h, w), np.float32)
    for freq, amp in ((29.0, 0.25), (61.0, 0.15), (131.0, 0.2)):
        ph1, ph2 = rng.uniform(0, 6.28, 2)
        base += amp * np.sin(xx / freq + ph1) * np.cos(yy / (freq * 0.8) + ph2)
    base = 0.55 + base

    # edges / blocks
    edges = 0.18 * (((xx // rng.integers(48, 128)).astype(int) ^ (yy // rng.integers(32, 96)).astype(int)) % 2)

    # texture octaves (band-limited noise)
    tex = np.zeros((h, w), np.float32)
    for scale, amp in ((4, 0.02), (16, 0.03)):
        n = rng.normal(0, 1, (h // scale + 2, w // scale + 2)).astype(np.float32)
        nn = np.kron(n, np.ones((scale, scale), np.float32))[:h, :w]
        tex += amp * nn
    tex += rng.normal(0, 0.012, (h, w)).astype(np.float32)

    lum = np.clip(base + edges + tex, 0.02, 0.98)
    r = lum * (0.8 + 0.2 * np.sin(yy / 97.0 + rng.uniform(0, 6)))
    g = lum
    b = lum * (0.7 + 0.3 * np.cos(xx / 83.0 + rng.uniform(0, 6)))
    rgb = np.stack([r, g, b], axis=-1)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def synth_graphics(h, w, seed):
    """Sharp-edged synthetic-graphics content (text-box/diagram-like):
    flat regions, high-contrast rectangles and thin lines — the regime
    where the thesis's homogeneity partitioning targets DCT4x4/8x4/4x8
    splits (proposals/homogeneity-partitioning.diff:213-235)."""
    rng = np.random.default_rng(seed)
    lum = np.full((h, w), 0.92, np.float32)
    for _ in range(28):
        y0, x0 = rng.integers(0, h - 16), rng.integers(0, w - 16)
        bh, bw = rng.integers(12, h // 3), rng.integers(12, w // 3)
        lum[y0 : y0 + bh, x0 : x0 + bw] = rng.uniform(0.05, 0.95)
    for _ in range(40):  # thin lines, both orientations
        if rng.random() < 0.5:
            y = rng.integers(0, h - 2)
            x0, x1 = sorted(rng.integers(0, w, 2))
            lum[y : y + rng.integers(1, 3), x0:x1] = rng.uniform(0.0, 1.0)
        else:
            x = rng.integers(0, w - 2)
            y0, y1 = sorted(rng.integers(0, h, 2))
            lum[y0:y1, x : x + rng.integers(1, 3)] = rng.uniform(0.0, 1.0)
    hue = rng.uniform(0, 6.28)
    r = np.clip(lum * (0.85 + 0.15 * np.cos(hue)), 0, 1)
    b = np.clip(lum * (0.85 + 0.15 * np.sin(hue)), 0, 1)
    return (np.stack([r, lum, b], axis=-1) * 255).astype(np.uint8)


def synth_portrait(h, w, seed):
    """Smooth-gradient-dominated content (sky/skin-like): large radial
    gradients + a few soft blobs + mild grain — the regime where big
    merged transforms (16x16..64x64) and DC fidelity dominate."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    rad = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) / np.hypot(h, w)
    lum = 0.75 - 0.45 * rad
    for _ in range(6):  # soft blobs
        by, bx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(0.05, 0.2) * min(h, w)
        a = rng.uniform(-0.12, 0.12)
        lum += a * np.exp(-(((yy - by) ** 2 + (xx - bx) ** 2) / (2 * s * s)))
    lum += rng.normal(0, 0.004, (h, w)).astype(np.float32)  # mild grain
    lum = np.clip(lum, 0.02, 0.98)
    r = lum * (0.95 + 0.05 * np.sin(yy / 151.0))
    b = lum * (0.82 + 0.1 * np.cos(xx / 177.0))
    return (np.clip(np.stack([r, lum, b], axis=-1), 0, 1) * 255).astype(np.uint8)


def synth_text(h, w, seed):
    """Screenshot/text-like content: white page, dark glyph-box "text"
    lines at fixed pitch, a menu bar and window chrome — the family where
    codecs embarrass themselves (hard 1-px strokes everywhere, huge flat
    runs) and where palette/RLE-style coding dominates at d=0."""
    rng = np.random.default_rng(seed)
    lum = np.full((h, w), 0.97, np.float32)
    lum[: h // 24, :] = 0.75  # title bar
    lum[h // 24 : h // 24 + 2, :] = 0.45
    pitch = 18
    for y0 in range(h // 12, h - pitch, pitch):
        x = rng.integers(10, 40)
        line_end = rng.integers(w // 2, w - 10)
        while x < line_end:
            gw = int(rng.integers(4, 14))  # glyph-box width
            gh = int(rng.integers(7, 11))
            if rng.random() < 0.82:  # glyph vs inter-word space
                shade = rng.uniform(0.05, 0.25)
                # glyph = outline box with random internal strokes
                lum[y0 : y0 + 1, x : x + gw] = shade
                lum[y0 + gh : y0 + gh + 1, x : x + gw] = shade
                lum[y0 : y0 + gh, x : x + 1] = shade
                if rng.random() < 0.5:
                    lum[y0 + gh // 2 : y0 + gh // 2 + 1, x : x + gw] = shade
                if rng.random() < 0.5:
                    lum[y0 : y0 + gh, x + gw - 1 : x + gw] = shade
            x += gw + int(rng.integers(1, 5))
    # a sidebar and a highlighted selection
    lum[:, : w // 8] = np.minimum(lum[:, : w // 8], 0.88)
    y0 = int(rng.integers(h // 3, 2 * h // 3))
    sel = lum[y0 : y0 + pitch, w // 8 :]
    rgb = np.stack([lum, lum, lum], axis=-1)
    rgb[y0 : y0 + pitch, w // 8 :, 2] = np.minimum(sel + 0.08, 1.0)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def synth_diag(h, w, seed):
    """Hard-diagonal-edge graphics: flat polygonal fills meeting at
    aliased non-axis-aligned boundaries plus thin diagonal strokes — the
    worst case for axis-aligned DCT bases (ringing along the diagonals)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    lum = np.full((h, w), 0.5, np.float32)
    def proj_range(ang):
        corners = [0.0, np.cos(ang) * w, np.sin(ang) * h, np.cos(ang) * w + np.sin(ang) * h]
        return min(corners), max(corners)

    for _ in range(10):  # half-plane fills, random orientation
        ang = rng.uniform(0, np.pi)
        lo, hi = proj_range(ang)
        c = rng.uniform(lo + 0.2 * (hi - lo), hi - 0.2 * (hi - lo))
        mask = (np.cos(ang) * xx + np.sin(ang) * yy) > c
        lum[mask] = rng.uniform(0.05, 0.95)
    for _ in range(24):  # thin diagonal strokes
        ang = rng.uniform(0.15, np.pi - 0.15)
        lo, hi = proj_range(ang)
        c = rng.uniform(lo, hi)
        d = np.cos(ang) * xx + np.sin(ang) * yy - c
        lum[np.abs(d) < rng.uniform(0.7, 1.8)] = rng.uniform(0.0, 1.0)
    hue = rng.uniform(0, 6.28)
    r = np.clip(lum * (0.88 + 0.12 * np.cos(hue)), 0, 1)
    b = np.clip(lum * (0.88 + 0.12 * np.sin(hue)), 0, 1)
    return (np.stack([r, lum, b], axis=-1) * 255).astype(np.uint8)


def synth_sky(h, w, seed):
    """Smooth sky/sunset gradient at near-16-bit precision: very slow
    large-scale ramps with almost no texture — the banding/DC-fidelity
    regime (any quantization coarseness shows as visible contours)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = yy / h
    ph = rng.uniform(0, 6.28)
    r = 0.85 - 0.55 * t + 0.04 * np.sin(xx / w * 2.2 + ph)
    g = 0.55 - 0.30 * t + 0.03 * np.sin(xx / w * 1.7 + ph + 1.1)
    b = 0.45 + 0.25 * t + 0.02 * np.cos(xx / w * 1.3 + ph)
    # a soft sun disk and faint horizontal cloud bands
    cy, cx = rng.uniform(0.15, 0.45) * h, rng.uniform(0.3, 0.7) * w
    disk = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * (0.06 * h) ** 2)))
    r = r + 0.18 * disk
    g = g + 0.12 * disk
    for _ in range(4):
        by = rng.uniform(0.2, 0.9) * h
        bw_ = rng.uniform(0.01, 0.03) * h
        band = 0.03 * np.exp(-(((yy - by) / bw_) ** 2))
        r += band
        g += band * 0.8
    rgb = np.stack([r, g, b], axis=-1) + rng.normal(0, 0.0015, (h, w, 1))
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


# content family per corpus index: photographic texture x2, sharp
# graphics, smooth portrait (indices 0-7 — the committed round-3 corpus,
# unchanged), then the round-4 families: text/screenshot, hard diagonal
# edges, smooth sky gradient, and a second text sample (VERDICT r3
# item 5 / weak 6).
GENERATORS = (
    synth_photo,
    synth_photo,
    synth_graphics,
    synth_portrait,
    synth_photo,
    synth_photo,
    synth_graphics,
    synth_portrait,
    synth_text,
    synth_diag,
    synth_sky,
    synth_text,
)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--size", default="512x768", help="HxW")
    args = parse(ap, argv)

    from jxl_tpu_torch.core.io import write_image

    h, w = (int(s) for s in args.size.split("x"))
    out_dir = os.path.join(args.out, "synth")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(args.n):
        path = os.path.join(out_dir, f"synth{i:02d}.png")
        gen = GENERATORS[i % len(GENERATORS)]
        write_image(path, gen(h, w, seed=100 + i))
        print("wrote", path, gen.__name__)


if __name__ == "__main__":
    main()
