"""Per-image histogram clustering (port of `jxl_tpu/entropy/cluster.py`).

The small-context modes (lossless / modular, 12 contexts) run the greedy
pairwise merge `cluster_histograms`. The v8 lossy context set (765) runs
`cluster_histograms_kmeans`, two stages as in the reference: a Lloyd
k-means on the cross-entropy objective seeded by a static structural
grouping of the 765 contexts (the 9 non-AC contexts alone, AC contexts by
bucket x channel x coarse band), then a header-aware agglomerative merge
of the <= k centres in a few vectorised rounds (mutual best pairs with a
negative dH - header-saving score merge). The cost matrix and centre
updates are float32 matrix products (TF32 off, see core.device).
"""

from __future__ import annotations

import numpy as np
import torch

from jxl_tpu_torch.codec.layout import CTX_AC_BASE, N_CTX, NNZ_Q


def _entropy_bits(c: torch.Tensor) -> torch.Tensor:
    """[..., A] counts -> [...] bits to code them with an ideal dedicated
    table (n*log2(n) - sum n_s*log2(n_s))."""
    cf = c.to(torch.float32)
    n = torch.sum(cf, dim=-1)
    return n * torch.log2(torch.clamp(n, min=1.0)) - torch.sum(
        cf * torch.log2(torch.clamp(cf, min=1.0)), dim=-1
    )


def _pair_scores(c: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[k, k] merge scores of count rows c [k, A]: the payload growth
    dH = H(c_i + c_j) - H(c_i) - H(c_j) minus the header bytes one merged
    sparse table saves (8 * (2 + 3 * |shared symbols|) bits); +inf where
    not `valid`."""
    h = _entropy_bits(c)
    d_h = _entropy_bits(c[:, None, :] + c[None, :, :]) - h[:, None] - h[None, :]
    nz = c > 0.0
    overlap = torch.sum((nz[:, None, :] & nz[None, :, :]).to(torch.float32), dim=-1)
    return torch.where(valid, d_h - 8.0 * (2.0 + 3.0 * overlap), torch.inf)


def cluster_histograms(counts: torch.Tensor):
    """Greedy merge of the small-context modes (lossless / modular): C - 1
    rounds, each merging the lowest-scoring live pair (i < j, first flat
    index on ties, j folds into i) while its score is negative.

    counts [C, A] -> (expanded [C, A] int32, row c holding its cluster's
    merged counts; cmap [C] int64 cluster representative ids). Runs on the
    device without host syncs."""
    C = counts.shape[0]
    dev = counts.device
    c = counts.to(torch.float32)
    iota = torch.arange(C, device=dev)
    alive = torch.ones(C, dtype=torch.bool, device=dev)
    cmap = iota.clone()
    for _ in range(C - 1):
        valid = alive[:, None] & alive[None, :] & (iota[:, None] < iota[None, :])
        score = _pair_scores(c, valid).reshape(-1)
        flat = torch.argmin(score)
        bi, bj = flat // C, flat % C
        do = score[flat] < 0.0
        merged = c.clone()
        merged[bi] = c[bi] + c[bj]
        merged[bj] = 0.0
        c = torch.where(do, merged, c)
        alive = alive & ~(do & (iota == bj))
        cmap = torch.where(do & (cmap == bj), bi, cmap)
    return torch.round(c[cmap]).to(torch.int32), cmap


def _structural_groups(C: int, k: int) -> np.ndarray:
    """[C] static initial group ids: the 9 non-AC contexts individually,
    AC contexts by (bucket, channel, coarse band); id % k for other
    context counts."""
    if C != N_CTX or k < CTX_AC_BASE + 3 * 3 * NNZ_Q:
        return (np.arange(C) % k).astype(np.int32)
    g = np.zeros(C, np.int32)
    g[:CTX_AC_BASE] = np.arange(CTX_AC_BASE)
    pos = np.arange(3 * 63 * NNZ_Q)  # (q * 3 + c) * 63 + (p - 1)
    p1 = pos % 63 + 1
    qc = pos // 63
    band4 = (p1 >= 2).astype(np.int32) + (p1 >= 8) + (p1 >= 32)
    g[CTX_AC_BASE:] = CTX_AC_BASE + qc * 4 + band4
    return g


def _merge_rounds(c: torch.Tensor, k: int, rounds: int = 5):
    """Vectorised agglomerative merge over k clusters; returns (counts,
    cmap [k])."""
    dev = c.device
    iota = torch.arange(k, device=dev)
    alive = torch.ones(k, dtype=torch.bool, device=dev)
    cmap = iota.clone()
    for _ in range(rounds):
        valid = alive[:, None] & alive[None, :] & (iota[:, None] != iota[None, :])
        score = _pair_scores(c, valid)
        best_j = torch.argmin(score, dim=1)
        best_s = torch.gather(score, 1, best_j[:, None])[:, 0]
        mutual = (best_j[best_j] == iota) & (best_s < 0.0) & alive
        absorb = mutual & (iota > best_j)  # higher index folds into lower
        gain = mutual & (iota < best_j)
        c = c + torch.where(gain[:, None], c[best_j], 0.0)
        c = torch.where(absorb[:, None], 0.0, c)
        alive = alive & ~absorb
        rep = torch.where(absorb, best_j, iota)
        cmap = rep[cmap]
    return c, cmap


def cluster_histograms_kmeans(counts: torch.Tensor, k: int = 64, iters: int = 6):
    """counts [C, A] -> (cmap [C] int64 cluster ids in [0, k), ctables
    [k, A] int64 merged counts; rows of dead clusters are zero). Any symbol
    that occurs in a member context keeps a positive centre count."""
    C, _A = counts.shape
    dev = counts.device
    cf = counts.to(torch.float32)
    ar = torch.arange(k, device=dev)

    def assign(centers):
        p = centers / torch.clamp(torch.sum(centers, dim=1, keepdim=True), min=1.0)
        logp = torch.log2(torch.clamp(p, min=1e-8))
        return torch.argmin(-torch.matmul(cf, logp.T), dim=1)

    def update(groups):
        oh = (groups[:, None] == ar[None, :]).to(torch.float32)
        return torch.matmul(oh.T, cf)

    centers = update(torch.from_numpy(_structural_groups(C, k)).to(dev).to(torch.int64))
    for _ in range(iters):
        centers = update(assign(centers))
    groups = assign(centers)
    centers = update(groups)
    merged, inner_map = _merge_rounds(centers, k)
    return inner_map[groups], torch.round(merged).to(torch.int64)
