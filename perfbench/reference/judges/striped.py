"""The comparison that decides a run's `correct`, for striped JXTS containers
of VarDCT sections (`perfbench/reference/striped.py`).

It has the `vardct` judge's interface (`Point`, `judge`, `control_points`,
`verdict`). Each judged point is one striped round trip of an original: its
wrapper and the program's decoded pixels of the whole image. The judge holds
up a run of `RUN` adjacent sections, a centre and its neighbours (2 at the
image's edge), the centre drawn with a generator seeded from the original's
pixels, which the run's seed makes:

- `encode_mismatch`: the largest over the run's sections, each judged as
  the `vardct` judge judges a point, against the frozen front end on its own
  stripe of the original (the widths `stripe_widths` gives for the wrapper's
  section count). A wrapper that does not parse or names another geometry, a
  section of the modular family (which this judge does not cover), or a
  section whose header names another geometry, distance, effort or strategy
  reads 1.
- `decode_mismatch`: the share of 8-bit samples of the program's decoded
  pixels that differ from the frozen stitch of the run's sections (their
  container values reconstructed, concatenated, one EPF pass if the vote over
  **all** sections' headers says so, then the colour transform). Every
  column of the run is compared except the `EDGE` columns at an outer edge
  that has a neighbour outside the run, where the reference replicates what
  the program filters with its true neighbour; so every seam inside the run
  is judged. Pixels of the wrong shape read 1.

The reference runs in full float32 on the device of the originals, as the
`vardct` judge's does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.container import read_container_header
from perfbench.reference.dct import matmul_precision
from perfbench.reference.judges import vardct
from perfbench.reference.quality import filter_precision
from perfbench.reference.striped import epf_vote, read_striped, section_planes, stitch, stripe_widths

RUN = 3  # sections a judged round trip holds up: a centre and its two neighbours
EDGE = 8  # columns left out at a run's edge that has a neighbour outside it


@dataclass
class Point:
    """One judged round trip. `container` holds the program's wrapper; a
    control puts in its place the run's sections' (values, params), every
    section's EPF bit and the run it judged."""

    orig: torch.Tensor  # u8 [H, W, 3]
    distance: float
    effort: int
    pixels: torch.Tensor  # u8 [H, W, 3], the decode judged
    strategy: str = "BASELINE"
    container: bytes | None = None
    battery: dict | None = None
    sections: dict | None = None  # {section index: (values [n] int64, encoder params)}
    epf: list | None = None  # every section's EPF bit
    run: tuple | None = None  # (first, end) of the judged sections


def draw_run(orig: torch.Tensor, n: int) -> tuple:
    """(first, end) of the run of sections judged for `orig` in a wrapper of
    `n` sections: a centre drawn from the original's first row, and its
    neighbours inside the image."""
    entropy = orig[0, :256].reshape(-1).cpu().numpy().astype(np.uint32)
    c = int(np.random.default_rng(entropy).integers(0, n))
    return max(0, c - 1), min(n, c + RUN - 1)


def _edges(width: int, n: int) -> list:
    return [0] + np.cumsum(stripe_widths(width, n)).tolist()


def _stripe(p: Point, x0: int, x1: int, container=None) -> vardct.Point:
    return vardct.Point(p.orig[:, x0:x1], p.distance, p.effort, None, p.strategy, container=container)


def _judged(p: Point):
    """(edges, run, {section: (values, decoder params) or None}, every
    section's EPF bit) of a point, or None where its wrapper does not parse,
    names another geometry or holds a modular section."""
    h, w = p.orig.shape[:2]
    if p.container is None:
        edges = _edges(w, len(p.epf))
        carried = {i: (np.asarray(v, np.int64), vardct.decode_params(params)) for i, (v, params) in p.sections.items()}
        return edges, p.run, carried, p.epf
    try:
        hh, ww, secs = read_striped(p.container)
        headers = [read_container_header(s) for s in secs]
        edges = _edges(ww, len(secs))
    except ValueError:
        return None
    if (hh, ww) != (h, w) or any(hd.lossless for hd in headers):
        return None
    a, b = p.run or draw_run(p.orig, len(secs))
    got = vardct._carried([_stripe(p, edges[i], edges[i + 1], secs[i]) for i in range(a, b)])
    return edges, (a, b), dict(zip(range(a, b), got)), [hd.epf for hd in headers]


def judge(points, detail: bool = False) -> dict:
    """The compared numbers over `points` (the largest over the points);
    with `detail`, also `decode_lsb`, the largest difference in 8-bit levels
    (a reading, not compared)."""
    dev = points[0].orig.device
    vardct._fp32(dev)
    enc, share, lsb = 0.0, 0.0, 0
    with matmul_precision("fp32"), filter_precision("fp32"):
        for p in points:
            h = p.orig.shape[0]
            got = _judged(p)
            if got is None or any(c is None for c in got[2].values()):
                enc, share, lsb = 1.0, 1.0, 255
                continue
            edges, (a, b), carried, votes = got
            d = vardct.floored(p.distance)
            parts, muls = [], []
            for i in range(a, b):
                values, dec_params = carried[i]
                x0, x1 = edges[i], edges[i + 1]
                ref_v, ref_p = vardct.reference_values(_stripe(p, x0, x1))
                ref_pix = vardct.reconstruct(ref_v, vardct.decode_params(ref_p), d, h, x1 - x0, dev)
                pix = vardct.reconstruct(values, dec_params, d, h, x1 - x0, dev)
                enc = max(enc, float((pix != ref_pix).float().mean()))
                planes, mul = section_planes(torch.as_tensor(values, device=dev), d, dec_params, h, x1 - x0)
                parts.append(planes)
                muls.append(mul)
            if tuple(p.pixels.shape) != tuple(p.orig.shape):
                share, lsb = 1.0, 255
                continue
            ref = stitch(parts, muls, d, height=h, width=edges[b] - edges[a], epf=epf_vote(votes))
            lo = EDGE if a > 0 else 0
            hi = ref.shape[1] - (EDGE if b < len(votes) else 0)
            prog = p.pixels[:, edges[a] + lo : edges[a] + hi].to(dev).to(torch.int32)
            diff = (prog - ref[:, lo:hi].to(torch.int32)).abs()
            lsb = max(lsb, int(diff.max()))
            share = max(share, float((diff > 0).float().mean()))
    out = {"encode_mismatch": enc, "decode_mismatch": share}
    if detail:
        out["decode_lsb"] = float(lsb)
    return out


def control_points(points, side: str = "control") -> list:
    """The reference in the program's place as `side` computes it
    (`vardct.SIDES`): for each point, the frozen front end's (values,
    params) of every stripe, of which the run's sections are kept with every
    section's EPF bit, and the pixels of the run stitched from those values
    (the rest of the image left 0, which the judge does not compare). The
    control ("control") runs the DCTs with every operand rounded to TF32,
    one step below the float32 that the configurations state;
    "fp32_reordered" is a sound float32 variant."""
    out = []
    dev = points[0].orig.device
    vardct._fp32(dev)
    mm, filt = vardct.SIDES[side]
    with matmul_precision(mm), filter_precision(filt):
        for p in points:
            h, w = p.orig.shape[:2]
            n = len(read_striped(p.container)[2])
            edges = _edges(w, n)
            a, b = p.run or draw_run(p.orig, n)
            d = vardct.floored(p.distance)
            sections, votes, parts, muls = {}, [], [], []
            for i in range(n):
                v, params = vardct.reference_values(_stripe(p, edges[i], edges[i + 1]))
                votes.append(bool((params >> 5) & 1))  # the encoder's EPF bit
                if a <= i < b:
                    sections[i] = (v, params)
                    planes, mul = section_planes(torch.as_tensor(v, device=dev), d, vardct.decode_params(params), h,
                                                 edges[i + 1] - edges[i])
                    parts.append(planes)
                    muls.append(mul)
            pix = torch.zeros_like(p.orig)
            pix[:, edges[a] : edges[b]] = stitch(parts, muls, d, height=h, width=edges[b] - edges[a],
                                                 epf=epf_vote(votes))
            out.append(Point(p.orig, p.distance, p.effort, pix, p.strategy, sections=sections, epf=votes, run=(a, b)))
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every compared number is within its limit."""
    return all(numbers[k] <= limits[k] for k in numbers)
