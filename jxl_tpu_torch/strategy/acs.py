"""AC-strategy search and the strategies' transforms (port of
`jxl_tpu/strategy/acs.py`).

Every candidate transform is computed for every block as batched matmuls,
scored by a rate proxy, and selected by argmin — the reference's
dense-then-select design, in torch. See the reference module for the
storage layout of each strategy (ids 0-3 sub-8 transforms in one 8x8
block, 4-8 the 16..256 merges in the strided coefficient mapping).

Ported here: the decoder's pieces for every strategy id (`steps_field`,
`effective_multiplier`, `reassemble_merged`), and the encoder's search
under every strategy, the thesis's homogeneity hooks included
(`strategy/homogeneity.py`): the proxy rate model up to effort 7 (the
sub-8 search and the 16/32/64 merge rungs), and from effort 8 the
measured rate of the two-pass model (`_rate_bits_lut`, the 128 and 256
rungs at e8 and e9).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from jxl_tpu_torch.entropy.tokens import tokenize, zigzag_map
from jxl_tpu_torch.strategy.homogeneity import (
    ACS_DCT,
    ACS_DCT4X4,
    ACS_DCT4X8,
    ACS_DCT8X4,
    homogeneity_partition,
    homogeneity_similarity_indices,
    hook_b_factor,
)
from jxl_tpu_torch.transforms.dct import dct2d, idct2d
from jxl_tpu_torch.transforms.quant import ac_steps_t

ACS_DCT16X16 = 4
ACS_DCT32X32 = 5
ACS_DCT64X64 = 6
ACS_DCT128X128 = 7
ACS_DCT256X256 = 8
N_STRATEGIES = 9

SQRT2 = float(np.sqrt(2.0))

# (pixel size, strategy id, minimum effort)
MERGE_LADDER = (
    (16, ACS_DCT16X16, 6),
    (32, ACS_DCT32X32, 7),
    (64, ACS_DCT64X64, 7),
    (128, ACS_DCT128X128, 8),
    (256, ACS_DCT256X256, 9),
)

ENTROPY_MUL = {
    ACS_DCT: 1.0,
    ACS_DCT4X4: 1.12,
    ACS_DCT8X4: 1.08,
    ACS_DCT4X8: 1.08,
    ACS_DCT16X16: 0.99,
    ACS_DCT32X32: 0.98,
    ACS_DCT64X64: 0.97,
    ACS_DCT128X128: 0.96,
    ACS_DCT256X256: 0.95,
}

NONZERO_BITS = 1.1


def log2_1p_fast(aq: torch.Tensor) -> torch.Tensor:
    """log2(1 + aq) for aq >= 0 via the float32 exponent trick (bit pattern
    of 1 + aq read as an integer), centred and clamped at 0 as in the
    reference."""
    v = aq.to(torch.float32) + 1.0
    bits = v.view(torch.int32)
    return torch.clamp(bits.to(torch.float32) * (1.0 / (1 << 23)) - 126.95, min=0.0)


def sub8_step_grids(distance, *, device) -> torch.Tensor:
    """[4, 3, 8, 8] quant-step grids on the 8x8 storage layout for the
    sub-8 strategies (DCT, DCT4X4, DCT8X4, DCT4X8)."""
    u = np.arange(8)
    s8 = ac_steps_t(distance, 8, 8, device=device)
    s4 = ac_steps_t(distance, 4, 4, device=device)[:, u[:, None] % 4, u[None, :] % 4]
    s84 = ac_steps_t(distance, 8, 4, device=device)[:, u[:, None], u[None, :] % 4]
    s48 = ac_steps_t(distance, 4, 8, device=device)[:, u[:, None] % 4, u[None, :]]
    return torch.stack([s8, s4, s84, s48])


def merged_step_slots(distance, n: int, *, device) -> torch.Tensor:
    """[3, k, k, 8, 8] per-sub-block step grids of the n x n transform in the
    strided mapping: slot (ky, kx)[u, v] = S[u*k + ky, v*k + kx]."""
    k = n // 8
    s = ac_steps_t(distance, n, n, device=device)
    return s.reshape(3, 8, k, 8, k).permute(0, 2, 4, 1, 3)


def _rate_bits(q: torch.Tensor, dims) -> torch.Tensor:
    """Rate proxy in bits over the given dims (q: integer quantised coeffs)."""
    aq = torch.abs(q).to(torch.float32)
    return torch.sum(2.0 * log2_1p_fast(aq) + NONZERO_BITS * (aq > 0).to(torch.float32), dim=dims)


def lut_bits(q: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Measured bits of each coefficient of q [..., 8, 8]: lut[..., sym]
    with sym the hybrid-uint token of zigzag(q), lut [..., 8, 8, A] of
    q's rank plus one, broadcasting against q. A gather: the reference's
    one-hot product over A has this as its single nonzero term, so the
    float is the same, without an [..., A] temporary."""
    sym = tokenize(zigzag_map(q))[0].to(torch.int64)
    return torch.gather(lut.expand(*q.shape, lut.shape[-1]), -1, sym[..., None])[..., 0]


def _rate_bits_lut(q: torch.Tensor, bit_lut: torch.Tensor, dims) -> torch.Tensor:
    """Measured rate in bits over the given dims: per coefficient, the rANS
    cost of its token under the image's first-pass histograms plus its
    mantissa bits. bit_lut [3, 8, 8, A] (`encode._bits_lut_grid`); q
    [3, ..., 8, 8], the LUT broadcasting over the middle axes."""
    lut = bit_lut.reshape((3,) + (1,) * (q.ndim - 3) + tuple(bit_lut.shape[1:]))
    return torch.sum(lut_bits(q, lut), dim=dims)


def _mask_dc_slot(storage: torch.Tensor) -> torch.Tensor:
    out = storage.clone()
    out[..., 0, 0] = 0.0
    return out


def candidates_sub8(blocks: torch.Tensor) -> dict:
    """Per-block coefficient storages for strategies 0..3.

    blocks: [3, nby, nbx, 8, 8] pixel blocks. Returns id -> storage
    [3, nby, nbx, 8, 8] float32 (DC slot zeroed, Haar-mixed sub-DC slots
    filled per the layout table)."""
    lead = blocks.shape[:-2]
    c8 = dct2d(blocks)

    q = blocks.reshape(*lead, 2, 4, 2, 4).permute(0, 1, 2, 3, 5, 4, 6)
    c44 = dct2d(q)  # [3, nby, nbx, 2, 2, 4, 4]
    m = dct2d(c44[..., 0, 0])  # orthonormal 2x2 DCT of the sub-DC matrix
    st44 = c44.permute(0, 1, 2, 3, 5, 4, 6).reshape(*lead, 8, 8).clone()
    st44[..., 0, 0] = 0.0
    st44[..., 0, 4] = m[..., 0, 1]
    st44[..., 4, 0] = m[..., 1, 0]
    st44[..., 4, 4] = m[..., 1, 1]

    halves = blocks.reshape(*lead, 8, 2, 4).permute(0, 1, 2, 4, 3, 5)
    c84 = dct2d(halves)  # [3, nby, nbx, 2, 8, 4]
    s0, s1 = c84[..., 0, 0, 0], c84[..., 1, 0, 0]
    st84 = c84.permute(0, 1, 2, 4, 3, 5).reshape(*lead, 8, 8).clone()
    st84[..., 0, 0] = 0.0
    st84[..., 0, 4] = (s0 - s1) / SQRT2

    c48 = dct2d(blocks.reshape(*lead, 2, 4, 8))  # [3, nby, nbx, 2, 4, 8]
    t0, t1 = c48[..., 0, 0, 0], c48[..., 1, 0, 0]
    st48 = c48.reshape(*lead, 8, 8).clone()
    st48[..., 0, 0] = 0.0
    st48[..., 4, 0] = (t0 - t1) / SQRT2

    return {ACS_DCT: _mask_dc_slot(c8), ACS_DCT4X4: st44, ACS_DCT8X4: st84, ACS_DCT4X8: st48}


def candidates_merged(planes: torch.Tensor, n: int) -> torch.Tensor:
    """n x n DCT over aligned groups -> storage slots [3, gby, gbx, k, k, 8, 8]
    in the strided mapping slot (ky, kx)[u, v] = C[u*k + ky, v*k + kx]; the
    C[:k, :k] corner is zero (rebuilt from the DC plane at decode)."""
    k = n // 8
    h, w = planes.shape[-2:]
    gby, gbx = h // n, w // n
    region = planes[:, : gby * n, : gbx * n]
    tiles = region.reshape(3, gby, n, gbx, n).permute(0, 1, 3, 2, 4)
    c = dct2d(tiles).clone()
    c[..., :k, :k] = 0.0
    return c.reshape(3, gby, gbx, 8, k, 8, k).permute(0, 1, 2, 4, 6, 3, 5)


def reassemble_merged(slots: torch.Tensor, dc_block: torch.Tensor) -> torch.Tensor:
    """Inverse of candidates_merged + lowfreq injection: slots
    [3, gby, gbx, k, k, 8, 8], dc_block [3, gby, gbx, k, k] -> pixel tiles
    [3, gby, gbx, n, n]."""
    k = slots.shape[3]
    n = k * 8
    c = slots.permute(0, 1, 2, 5, 3, 6, 4).reshape(*slots.shape[:3], n, n).clone()
    c[..., :k, :k] = dct2d(dc_block)
    return idct2d(c)


def group_min_multiplier(qf_mul: torch.Tensor, k: int) -> torch.Tensor:
    """Min-pool the per-block multiplier over aligned k x k groups and
    broadcast back (blocks outside full groups get 1.0)."""
    nby, nbx = qf_mul.shape
    gby, gbx = nby // k, nbx // k
    if gby == 0 or gbx == 0:
        return qf_mul
    pooled = qf_mul[: gby * k, : gbx * k].reshape(gby, k, gbx, k).amin(dim=(1, 3))
    up = torch.repeat_interleave(torch.repeat_interleave(pooled, k, dim=0), k, dim=1)
    return F.pad(up, (0, nbx - gbx * k, 0, nby - gby * k), value=1.0)


def _repeat2(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.repeat_interleave(torch.repeat_interleave(x, k, dim=0), k, dim=1)


def search_acs(
    blocks: torch.Tensor, planes: torch.Tensor, distance, *, effort: int, qf_mul: torch.Tensor,
    hook_a: int = 0, hook_b: bool = False, hooka_eps: float = 0.02, bit_lut: torch.Tensor | None = None,
):
    """AC-strategy search. Returns (acs [nby, nbx] int64, raw storage
    [3, nby, nbx, 8, 8] float32 of the selected strategies, qsteps
    [3, nby, nbx, 8, 8] step field).

    Candidates are costed by the proxy rate, or with bit_lut [3, 8, 8, A]
    (efforts >= 8, `encode._bits_lut_grid`) by the measured rate.

    The thesis's hooks (`codec.config.Strategy`):
    - hook A: where the 8x8-level argmin picked plain DCT, take the
      homogeneity partition's strategy instead; hook_a == 2 does so only
      where the partition's candidate costs at most (1 + hooka_eps) times
      the argmin's winner. Merge decisions use the cost from before the
      override, as the C++ stores it.
    - hook B: scale every sub-8 and merge candidate cost by 0.8 times the
      homogeneity factor of the candidate's top-left block."""
    if bit_lut is None:
        rate = _rate_bits
    else:

        def rate(q, dims):
            return _rate_bits_lut(q, bit_lut, dims)

    dev = blocks.device
    nby, nbx = blocks.shape[1], blocks.shape[2]
    sub8_steps = sub8_step_grids(distance, device=dev)
    if hook_a or hook_b:
        r_h, r_v, r_d = homogeneity_similarity_indices(planes, distance)
    bfac = hook_b_factor(r_h, r_v, r_d) if hook_b else None

    sub8 = candidates_sub8(blocks)
    costs = []
    for sid in range(4):
        steps = sub8_steps[sid][:, None, None] * qf_mul[None, :, :, None, None]
        qc = torch.round(sub8[sid] / steps).to(torch.int32)
        c = rate(qc, (0, -2, -1)) * ENTROPY_MUL[sid]
        if hook_b:
            c = c * 0.8 * bfac
        costs.append(c)
    stacked = torch.stack(costs)
    if effort >= 4:
        best8 = torch.argmin(stacked, dim=0)
    else:
        best8 = torch.zeros((nby, nbx), dtype=torch.int64, device=dev)
    cost_sel = torch.gather(stacked, 0, best8[None])[0]
    if hook_a:
        part = homogeneity_partition(r_h, r_v, r_d, distance)
        override = best8 == ACS_DCT
        if hook_a == 2:
            cost_part = torch.gather(stacked, 0, part[None])[0]
            override = override & (cost_part <= cost_sel * (1.0 + hooka_eps))
        best8 = torch.where(override, part, best8)
    acs = best8

    merged = []  # (slots, merge mask, n, sid) per attempted rung
    for n, sid, min_eff in MERGE_LADDER:
        k = n // 8
        gby, gbx = nby // k, nbx // k
        if effort < min_eff or gby == 0 or gbx == 0:
            continue
        slots = candidates_merged(planes, n)
        step_slots = merged_step_slots(distance, n, device=dev)[:, None, None]
        gmul = group_min_multiplier(qf_mul, k)[: gby * k : k, : gbx * k : k]
        qslots = torch.round(slots / (step_slots * gmul[None, :, :, None, None, None, None])).to(torch.int32)
        cost_m = rate(qslots, (0, -4, -3, -2, -1)) * ENTROPY_MUL[sid]
        if hook_b:
            cost_m = cost_m * 0.8 * bfac[: gby * k : k, : gbx * k : k]
        # group's current cost = sum of its selected per-block costs; the
        # epsilon breaks zero-cost ties toward the merge
        cur = cost_sel[: gby * k, : gbx * k].reshape(gby, k, gbx, k).sum(dim=(1, 3))
        merge = cost_m < cur + 1e-3
        pad = (0, nbx - gbx * k, 0, nby - gby * k)
        merge_full = F.pad(_repeat2(merge, k), pad)
        acs = torch.where(merge_full, sid, acs)
        new_cost = F.pad(_repeat2(cost_m / (k * k), k), pad)
        cost_sel = torch.where(merge_full, new_cost, cost_sel)
        merged.append((slots, merge, n, sid))

    sel = torch.clamp(acs, 0, 3)[None, :, :, None, None]
    raw = sub8[0]
    for s in range(1, 4):
        raw = torch.where(sel == s, sub8[s], raw)
    for slots, merge, n, sid in merged:
        k = n // 8
        gby, gbx = merge.shape
        # guard by the FINAL acs map: a bigger rung may have overridden it
        origin_is = acs[: gby * k : k, : gbx * k : k] == sid
        mb = F.pad(_repeat2(merge & origin_is, k), (0, nbx - gbx * k, 0, nby - gby * k))
        qs = slots.permute(0, 1, 3, 2, 4, 5, 6).reshape(3, gby * k, gbx * k, 8, 8)
        qs = F.pad(qs, (0, 0, 0, 0, 0, nbx - gbx * k, 0, nby - gby * k))
        raw = torch.where(mb[None, :, :, None, None], qs, raw)

    qsteps = steps_field(distance, acs, effective_multiplier(qf_mul, acs))
    return acs, raw, qsteps


def steps_field(distance, acs: torch.Tensor, eff_mul: torch.Tensor) -> torch.Tensor:
    """[3, nby, nbx, 8, 8] per-block quant-step field: one periodic tiling
    per size class plus masked selects."""
    nby, nbx = acs.shape
    dev = acs.device
    sel = acs[None, :, :, None, None]
    sub8 = sub8_step_grids(distance, device=dev)
    field = sub8[0][:, None, None].expand(3, nby, nbx, 8, 8)
    for s in (ACS_DCT4X4, ACS_DCT8X4, ACS_DCT4X8):
        field = torch.where(sel == s, sub8[s][:, None, None], field)
    for n, sid, _min_eff in MERGE_LADDER:
        k = n // 8
        if nby < k or nbx < k:
            continue  # merged id can't occur in a smaller image
        g = merged_step_slots(distance, n, device=dev)
        ry, rx = -(-nby // k), -(-nbx // k)
        t = g.repeat(1, ry, rx, 1, 1)[:, :nby, :nbx]
        field = torch.where(sel == sid, t, field)
    return field * eff_mul[None, :, :, None, None]


def effective_multiplier(qf_mul: torch.Tensor, acs: torch.Tensor) -> torch.Tensor:
    """Per-block step multiplier: merged transforms take the group minimum
    (same rule on both codec sides)."""
    eff = qf_mul
    for n, sid, _min_eff in MERGE_LADDER:
        eff = torch.where(acs == sid, group_min_multiplier(qf_mul, n // 8), eff)
    return eff
