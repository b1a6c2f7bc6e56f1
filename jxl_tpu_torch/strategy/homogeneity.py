"""Homogeneity statistics of the thesis's strategies (port of
`jxl_tpu/strategy/homogeneity.py`).

The thesis's proposal diffs insert a per-8x8-block helper block into
libjxl's `enc_ac_strategy.cc`; the reference (and this port) computes each
statistic for every block of an image at once:

- the 3x3 Laplacian {{0,-1,0},{-1,-4,-1},{0,-1,0}} of the luma plane, zero
  outside the image, and its threshold-run counts along rows and columns,
  averaged and floored like the C++ `size_t` return;
- the sum-modified Laplacian |2p-l-r| + |2p-u-d|, skipping pixels whose
  4-neighbourhood leaves the image;
- colourfulness sqrt(var_x + var_b) + 0.3 sqrt(mean_x^2 + mean_b^2) over the
  X and third planes;
- homogeneity = crossings + SML + colourfulness per sub-block, the ratios
  r_h, r_v, r_d over the 8x4 / 4x8 / diagonal-4x4 splits (with the C++'s
  precedence quirk: only the second term of each diagonal sum is halved),
  the partition rule and the factored-entropy cost factor.

Thresholds depend on the distance: Laplacian 0.25 (0.40 if d > 10, 0.15 if
d <= 2), partition 1.60 (1.80 if d > 10, 1.50 if d <= 3). Comparisons run
in float32, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the strategy ids the partition rule picks (shared with strategy/acs.py)
ACS_DCT = 0
ACS_DCT4X4 = 1
ACS_DCT8X4 = 2
ACS_DCT4X8 = 3


def laplacian_edge_threshold(distance) -> float:
    d = float(distance)
    return 0.40 if d > 10.0 else (0.15 if d <= 2.0 else 0.25)


def partition_threshold(distance) -> float:
    d = float(distance)
    return 1.80 if d > 10.0 else (1.50 if d <= 3.0 else 1.60)


def _neighbours(y_plane: torch.Tensor):
    """(centre, up, down, left, right) of every pixel, zero outside."""
    yp = F.pad(y_plane, (1, 1, 1, 1))
    return yp[1:-1, 1:-1], yp[:-2, 1:-1], yp[2:, 1:-1], yp[1:-1, :-2], yp[1:-1, 2:]


def _laplacian_map(y_plane: torch.Tensor) -> torch.Tensor:
    c, up, down, left, right = _neighbours(y_plane)
    return -4.0 * c - up - down - left - right


def _sml_map(y_plane: torch.Tensor) -> torch.Tensor:
    """|2p-l-r| + |2p-u-d|, zero where the neighbourhood leaves the image."""
    h, w = y_plane.shape
    c, up, down, left, right = _neighbours(y_plane)
    sml = torch.abs(2.0 * c - left - right) + torch.abs(2.0 * c - up - down)
    mask = torch.zeros((h, w), dtype=torch.bool, device=y_plane.device)
    mask[1 : h - 1, 1 : w - 1] = True
    return torch.where(mask, sml, 0.0)


def _to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[Hp, Wp] -> [nby, nbx, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


# the 8 sub-block geometries (rows, cols) of the similarity indices
_SUBBLOCKS = {
    "h1": (slice(0, 4), slice(0, 8)),  # 8x4 top
    "h2": (slice(4, 8), slice(0, 8)),  # 8x4 bottom
    "v1": (slice(0, 8), slice(0, 4)),  # 4x8 left
    "v2": (slice(0, 8), slice(4, 8)),  # 4x8 right
    "q00": (slice(0, 4), slice(0, 4)),
    "q11": (slice(4, 8), slice(4, 8)),
    "q01": (slice(0, 4), slice(4, 8)),
    "q10": (slice(4, 8), slice(0, 4)),
}


def _zero_crossings(lap_blocks: torch.Tensor, rows: slice, cols: slice, threshold: float) -> torch.Tensor:
    """Row + column threshold-run counts per sub-block, each averaged over
    its lines, summed and floored."""
    above = lap_blocks[:, :, rows, cols] > threshold
    ys, xs = above.shape[-2], above.shape[-1]
    prev = F.pad(above, (1, 0))[..., :-1]
    h_cross = torch.sum(above & ~prev, dim=(-2, -1))
    prevv = F.pad(above, (0, 0, 1, 0))[..., :-1, :]
    v_cross = torch.sum(above & ~prevv, dim=(-2, -1))
    return torch.floor(h_cross.to(torch.float32) / ys + v_cross.to(torch.float32) / xs)


def _colorfulness(x_blocks: torch.Tensor, b_blocks: torch.Tensor, rows: slice, cols: slice) -> torch.Tensor:
    xs_ = x_blocks[:, :, rows, cols]
    bs_ = b_blocks[:, :, rows, cols]
    mean_x = torch.mean(xs_, dim=(-2, -1))
    mean_b = torch.mean(bs_, dim=(-2, -1))
    var_x = torch.mean((xs_ - mean_x[..., None, None]) ** 2, dim=(-2, -1))
    var_b = torch.mean((bs_ - mean_b[..., None, None]) ** 2, dim=(-2, -1))
    return torch.sqrt(var_x + var_b) + 0.3 * torch.sqrt(mean_x**2 + mean_b**2)


def homogeneity_all_subblocks(xyb_planes: torch.Tensor, distance) -> dict:
    """Homogeneity of every sub-block geometry of every 8x8 block.

    xyb_planes: [3, Hp, Wp] float32 (padded to multiples of 8), the codec's
    channel order. Returns geometry name -> [nby, nbx] float32."""
    x_p, y_p, b_p = xyb_planes[0], xyb_planes[1], xyb_planes[2]
    t = laplacian_edge_threshold(distance)
    lap_b = _to_blocks(_laplacian_map(y_p))
    sml_b = _to_blocks(_sml_map(y_p))
    x_b, b_b = _to_blocks(x_p), _to_blocks(b_p)
    out = {}
    for name, (rows, cols) in _SUBBLOCKS.items():
        zc = _zero_crossings(lap_b, rows, cols, t)
        sml = torch.sum(sml_b[:, :, rows, cols], dim=(-2, -1))
        out[name] = zc + sml + _colorfulness(x_b, b_b, rows, cols)
    return out


def homogeneity_similarity_indices(xyb_planes: torch.Tensor, distance):
    """(r_h, r_v, r_d) maps [nby, nbx]: max / min homogeneity of the two
    halves of each split; the diagonal sums halve only their second term,
    as the C++ does."""
    h = homogeneity_all_subblocks(xyb_planes, distance)
    r_h = torch.maximum(h["h1"], h["h2"]) / torch.minimum(h["h1"], h["h2"])
    r_v = torch.maximum(h["v1"], h["v2"]) / torch.minimum(h["v1"], h["v2"])
    d1 = h["q00"] + h["q11"] / 2.0
    d2 = h["q10"] + h["q01"] / 2.0
    r_d = torch.maximum(d1, d2) / torch.minimum(d1, d2)
    return r_h, r_v, r_d


def homogeneity_partition(r_h, r_v, r_d, distance) -> torch.Tensor:
    """Strategy id per block [nby, nbx] int64: r_d over the threshold ->
    DCT4X4, else the larger of r_h / r_v over it -> DCT8X4 / DCT4X8, else
    DCT. NaN ratios compare False and keep DCT, as in the C++."""
    t = partition_threshold(distance)
    out = torch.full(r_h.shape, ACS_DCT, dtype=torch.int64, device=r_h.device)
    out = torch.where((r_h > r_v) & (r_h > t), ACS_DCT8X4, out)
    out = torch.where((r_v > r_h) & (r_v > t), ACS_DCT4X8, out)
    return torch.where(r_d > t, ACS_DCT4X4, out)


def hook_b_factor(r_h, r_v, r_d) -> torch.Tensor:
    """Cost multiplier of the factored-entropy variant: 0.8 * mean(r_h,
    r_v, r_d), or 1 where that is not finite (degenerate blocks)."""
    f = 0.8 * ((r_h + r_v + r_d) / 3.0)
    return torch.where(torch.isfinite(f), f, 1.0)
