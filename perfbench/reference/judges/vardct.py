"""The comparison that decides a run's `correct`, for the VarDCT family.

A configuration names its judge in `judge`: the module
`perfbench/reference/judges/<judge>.py`, whose `judge(points)` returns the
compared numbers and whose `control_points(points)` puts the reference,
one precision step down, in the program's place.

Each judged point is one encode and decode of an original image at one
(distance, effort, strategy), as the timed path produced it: its container, its
decoded pixels and, in a sweep, its metric-battery row. The reference works
everything out again from the original and the container, with the frozen
code of this package only:

- `encode_mismatch`: the encoder. The image that the container's value
  stream (read by `values.decode_values_np`) and decoder parameters
  reconstruct (`codec._reconstruct`), against the image that the value
  stream of the frozen front end (`codec.tokens_from_rgb`) reconstructs,
  made from the original at the point's distance, effort and strategy (its
  homogeneity hooks, `STRATEGIES`): the share of 8-bit samples that
  differ. It compares what a stream means, not its positions: one block's
  decision moving a block to another nnz bucket shifts every later entry
  of the stream and changes a few pixels. A container that does not parse,
  or whose header names another geometry, distance, effort, strategy or
  coding family, reads 1.
- `decode_mismatch`: the decoder. The share of 8-bit samples of the
  program's decoded pixels that differ from the frozen reconstruction of
  the container's value stream. Pixels of the wrong shape read 1.
- `battery_gap`: the metric battery. For each column, the gap between the
  program's value and the frozen battery's over the original and the
  program's decoded pixels (the battery is judged on its own inputs; the
  decoder is judged by `decode_mismatch`), in units of that column's bar
  (`BARS`, the tolerances by which the battery's columns are held across
  devices); the largest.

The reference runs in full float32 (TF32 off, `dct.matmul_precision
("fp32")`, `quality.filter_precision("fp32")`), on the device of the
originals.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.battery import metric_battery_grid_async
from perfbench.reference.codec import _reconstruct, tokens_from_rgb
from perfbench.reference.container import read_container
from perfbench.reference.dct import matmul_precision
from perfbench.reference.quality import filter_precision
from perfbench.reference.values import decode_values_np

# strategy name -> (code in the container, hook_a, hook_b), as the
# configurations name them (the thesis's AC-strategy variants)
STRATEGIES = {
    "BASELINE": (0, 0, False),
    "HOMOGENEITY_PARTITIONING": (1, 1, False),
    "HOMOGENEITY_FACTORED_ENTROPY": (2, 0, True),
    "COMBINED": (3, 1, True),
    "HOMOGENEITY_RD_GATED": (4, 2, False),
}

# a side put in the program's place -> (DCT precision, filter precision)
SIDES = {"control": ("tf32", "bf16"), "fp32_reordered": ("fp32_reordered", "fp32_reordered")}

# column -> (kind, bar): "rel" gaps are relative to the reference's value
BARS = {
    "mse": ("rel", 1e-6),
    "psnr": ("abs", 1e-5),
    "ssim": ("abs", 1e-5),
    "ms_ssim": ("abs", 1e-5),
    "butteraugli": ("rel", 3e-4),
    "butteraugli_pnorm": ("rel", 1e-4),
    "ssimulacra2": ("abs", 0.05),
}


@dataclass
class Point:
    """One judged point. `container` holds the program's bytes; a control
    puts `values` and `params` (what a container would carry) in its place."""

    orig: torch.Tensor  # u8 [H, W, 3]
    distance: float
    effort: int
    pixels: torch.Tensor  # u8 [H, W, 3], the decode judged
    strategy: str = "BASELINE"
    container: bytes | None = None
    battery: dict | None = None
    values: np.ndarray | None = None
    params: int | None = None


def decode_params(params: int) -> int:
    """The decoder's params word of a lossy stream coded with `params`
    (`container.JxtHeader.decode_params` with the EPF flag from bit 5)."""
    return (
        (params & 3) | 0b100 | (((params >> 2) & 1) << 3) | (((params >> 3) & 1) << 4)
        | (((params >> 4) & 1) << 5) | (((params >> 5) & 1) << 6)
    )


def floored(distance: float) -> float:
    """The distance a lossy point is coded at (the program floors at 0.05),
    as the container's float32 field holds it."""
    return float(np.float32(max(float(distance), 0.05)))


def _carried(points) -> list:
    """Each point's (values [n] int64, decoder params) as its container
    carries them, or None where the container is not a stream of this
    point."""
    out = [None] * len(points)
    groups = {}
    for i, p in enumerate(points):
        if p.container is None:
            out[i] = (np.asarray(p.values, np.int64), decode_params(p.params))
            continue
        try:
            s = read_container(p.container)
        except ValueError:
            continue
        hd = s.header
        h, w = p.orig.shape[:2]
        if (hd.height, hd.width, hd.effort, hd.strategy, hd.lossless) != (h, w, p.effort, STRATEGIES[p.strategy][0],
                                                                           False):
            continue
        if float(np.float32(hd.distance)) != floored(p.distance):
            continue
        groups.setdefault((hd.height, hd.width, hd.lanes), []).append((i, s))
    for members in groups.values():
        vals = decode_values_np([s for _i, s in members])
        for (i, s), v in zip(members, vals):
            out[i] = (v, s.header.decode_params)
    return out


def reference_values(p: Point):
    """The frozen front end's (values [n] int64, params) for a point."""
    h, w = p.orig.shape[:2]
    _code, hook_a, hook_b = STRATEGIES[p.strategy]
    _t, _n, _m, params, _q, values = tokens_from_rgb(
        p.orig, floored(p.distance), height=h, width=w, effort=int(p.effort), hook_a=hook_a, hook_b=hook_b
    )
    return values.cpu().numpy().astype(np.int64), int(params)


def reconstruct(values, dec_params: int, distance: float, h: int, w: int, device) -> torch.Tensor:
    v = torch.as_tensor(np.asarray(values, np.int64), device=device)
    return _reconstruct(v, floored(distance), dec_params, height=h, width=w)


def battery_gap(prog: dict, ref: dict) -> float:
    """Largest gap between two battery rows, in units of each column's bar."""
    worst = 0.0
    for col, (kind, bar) in BARS.items():
        a, b = float(prog[col]), float(ref[col])
        if math.isinf(a) or math.isinf(b):
            gap = 0.0 if a == b else math.inf
        else:
            gap = abs(a - b) / (max(abs(b), 1e-30) if kind == "rel" else 1.0)
        worst = max(worst, gap / bar)
    return worst


def _fp32(device):
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def judge(points, detail: bool = False) -> dict:
    """The compared numbers over `points` (the largest over the points);
    with `detail`, also `decode_lsb`, the largest difference in 8-bit levels
    (a reading, not compared)."""
    dev = points[0].orig.device
    _fp32(dev)
    carried = _carried(points)
    enc, lsb, bat, share = 0.0, 0, None, 0.0
    with matmul_precision("fp32"), filter_precision("fp32"):
        rows = []
        for p, c in zip(points, carried):
            h, w = p.orig.shape[:2]
            if c is None:
                enc, lsb, share = 1.0, 255, 1.0
                if p.battery is not None:
                    bat = math.inf
                continue
            ref_v, ref_p = reference_values(p)
            ref_pix = reconstruct(ref_v, decode_params(ref_p), p.distance, h, w, dev)
            pix = reconstruct(c[0], c[1], p.distance, h, w, dev)
            enc = max(enc, float((pix != ref_pix).float().mean()))
            if tuple(p.pixels.shape) != tuple(pix.shape):
                lsb, share = 255, 1.0
                if p.battery is not None:
                    bat = math.inf
                continue
            d = (p.pixels.to(dev).to(torch.int32) - pix.to(torch.int32)).abs()
            lsb = max(lsb, int(d.max()))
            share = max(share, float((d > 0).float().mean()))
            if p.battery is not None:
                rows.append(p)
        for p in rows:
            ref_row = metric_battery_grid_async(p.orig, p.pixels.to(dev)[None])()[0]
            g = battery_gap(p.battery, ref_row)
            bat = g if bat is None else max(bat, g)
    out = {"encode_mismatch": enc, "decode_mismatch": share}
    if bat is not None:
        out["battery_gap"] = bat
    if detail:
        out["decode_lsb"] = float(lsb)
    return out


def control_points(points, side: str = "control") -> list:
    """The reference in the program's place as `side` computes it (`SIDES`):
    for each point, the value stream and params of the front end, the pixels
    of their reconstruction and, where the point has a battery row, the
    battery over those pixels. The control ("control") runs the DCTs with
    every operand rounded to TF32 and the battery's filters in bfloat16, one
    step below the float32 that the configurations state;
    "fp32_reordered" is a sound float32 variant (products and filter passes
    in another order), one of the readings a limit's lower end is set
    from."""
    out = []
    _fp32(points[0].orig.device)
    mm, filt = SIDES[side]
    with matmul_precision(mm), filter_precision(filt):
        for p in points:
            h, w = p.orig.shape[:2]
            v, params = reference_values(p)
            pix = reconstruct(v, decode_params(params), p.distance, h, w, p.orig.device)
            bat = None if p.battery is None else metric_battery_grid_async(p.orig, pix[None])()[0]
            out.append(Point(p.orig, p.distance, p.effort, pix, p.strategy, battery=bat, values=v, params=params))
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every compared number is within its limit."""
    return all(numbers[k] <= limits[k] for k in numbers)
