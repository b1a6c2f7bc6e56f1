"""The encoder's front end, frozen: pixels -> the value stream a container
carries, and the decode-side reconstruction.

A copy of `jxl_tpu_torch/codec/encode.py:tokens_from_rgb` and its helpers,
and of `jxl_tpu_torch/codec/decode.py:_reconstruct` and its helpers, taken
when the benchmark was defined, with the encoder's knobs fixed at their
defaults. No entropy coder: the benchmark judges a container by decoding its
value stream (`values.py`) and comparing it with `tokens_from_rgb` here.
Everything runs as plain torch ops on the device of the input.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.acs import (
    ACS_DCT4X4,
    ACS_DCT4X8,
    ACS_DCT8X4,
    MERGE_LADDER,
    N_STRATEGIES,
    effective_multiplier,
    log2_1p_fast,
    lut_bits,
    reassemble_merged,
    search_acs,
    steps_field,
)
from perfbench.reference.adaptive import QF_CENTER_IDX, QF_LEVELS, qf_multiplier, quant_field
from perfbench.reference.dct import idct2d, inverse_zigzag_order, permute_last, zigzag_order
from perfbench.reference.epf import epf_apply
from perfbench.reference.layout import CTX_AC_BASE, NNZ_EDGES, NNZ_Q, token_layout
from perfbench.reference.quant import ac_recon_bias, dc_steps_t, dequant_ac_biased
from perfbench.reference.tokens import ALPHABET, token_nbits, tokenize, zigzag_map, zigzag_unmap
from perfbench.reference.xyb import srgb_to_xyb, xyb_to_srgb

RANS_PRECISION = 12
RANS_M = 1 << RANS_PRECISION
_SQRT2 = float(np.sqrt(2.0))


class Knobs:
    """The program's encoder knobs at their defaults (`EncoderKnobs`)."""

    deadzone = 0.12
    rdo_kappa = 0.12
    nnz_margin = 768.0
    nnz_force = None
    epf_force = None
    hooka_eps = 0.02


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along `dim`, in x's dtype."""
    return (torch.cumsum(x, dim=dim) - x).to(x.dtype)


def quantize_histograms_t(counts: torch.Tensor):
    """Per-context counts [C, A] -> (freq, cum) int32 tables summing to 2^12.

    Bit-exact twin of the reference's traced form: unused contexts put all
    mass on symbol 0; the ratio is taken in float32; every symbol with a
    nonzero count keeps freq >= 1; the argmax bucket absorbs the rounding
    remainder; single-symbol contexts are capped at M-1 so `f << 20` never
    overflows 32 bits in the encoder."""
    c = counts.to(torch.int32)
    a = c.shape[1]
    total = torch.sum(c, dim=1, keepdim=True).to(torch.int32)
    c = c.clone()
    c[:, 0] += (total[:, 0] == 0).to(torch.int32)
    total = torch.clamp(total, min=1)
    f = torch.floor((c.to(torch.float32) / total.to(torch.float32)) * RANS_M).to(torch.int32)
    f = torch.where((c > 0) & (f == 0), 1, f)
    diff = RANS_M - torch.sum(f, dim=1).to(torch.int32)
    am = torch.argmax(f, dim=1)
    col = torch.arange(a, device=c.device)[None, :]
    onehot_am = am[:, None] == col
    f = f + torch.where(onehot_am, diff[:, None], 0)
    over = (torch.amax(f, dim=1) >= RANS_M)[:, None]
    onehot_next = ((am + 1) % a)[:, None] == col
    f = f - (onehot_am & over).to(torch.int32) + (onehot_next & over).to(torch.int32)
    f = f.to(torch.int32)
    return f, exclusive_cumsum(f, dim=1)


def _entropy_bits(c: torch.Tensor) -> torch.Tensor:
    """[..., A] counts -> [...] bits to code them with an ideal dedicated
    table (n*log2(n) - sum n_s*log2(n_s))."""
    cf = c.to(torch.float32)
    n = torch.sum(cf, dim=-1)
    return n * torch.log2(torch.clamp(n, min=1.0)) - torch.sum(
        cf * torch.log2(torch.clamp(cf, min=1.0)), dim=-1
    )


def _bits_proxy(q: torch.Tensor) -> torch.Tensor:
    """Model-free per-coefficient rate proxy: 2*log2(1+|q|) + 1.1 per nonzero."""
    aq = torch.abs(q).to(torch.float32)
    return 2.0 * log2_1p_fast(aq) + 1.1 * (aq > 0).to(torch.float32)


def _quantize_ac(x: torch.Tensor, steps: torch.Tensor, deadzone: float) -> torch.Tensor:
    """Round-to-nearest with a widened zero bin (efforts <= 4)."""
    t = x / steps
    q = torch.round(t).to(torch.int32)
    if deadzone > 0.0:
        q = torch.where(torch.abs(t) < 0.5 + deadzone, 0, q)
    return q


def _quantize_ac_rdo(
    x: torch.Tensor, steps: torch.Tensor, kappa: float, bit_lut: torch.Tensor | None = None, channel: int = 0,
) -> torch.Tensor:
    """RDO AC quantisation (efforts >= 5): per coefficient, the nearest level
    q0 or its toward-zero neighbour, whichever minimises
    (t - recon(q))^2 + kappa * bits(q), with the decoder's biased recon.
    bits is the proxy, or with bit_lut [3, 8, 8, A] (efforts >= 8) the
    measured cost of the coefficient's token in `channel`'s table row."""
    t = x / steps
    q0 = torch.round(t).to(torch.int32)
    q1 = q0 - torch.sign(q0)
    b = ac_recon_bias()

    def recon(q):
        qf = q.to(torch.float32)
        return qf - b * torch.sign(qf)

    if bit_lut is None:
        b0, b1 = _bits_proxy(q0), _bits_proxy(q1)
    else:
        lut = bit_lut[channel].reshape((1,) * (q0.ndim - 2) + tuple(bit_lut.shape[1:]))
        b0, b1 = lut_bits(q0, lut), lut_bits(q1, lut)
    c0 = (t - recon(q0)) ** 2 + kappa * b0
    c1 = (t - recon(q1)) ** 2 + kappa * b1
    return torch.where(c1 < c0, q1, q0)


def _bits_lut_grid(counts_pos: torch.Tensor) -> torch.Tensor:
    """[3, 8, 8, A] measured bit cost per (storage slot, symbol):
    log2(M / freq) under the per-position first-pass tables (counts_pos
    [3, 63, A], buckets marginalised) plus the token's mantissa bits. The
    (0, 0) slot is never coded, so its row costs zero."""
    freq, _cum = quantize_histograms_t(counts_pos.reshape(3 * 63, ALPHABET))
    dev = counts_pos.device
    sym_bits = torch.log2(RANS_M / torch.clamp(freq.to(torch.float32), min=1.0))
    sym_bits = sym_bits + token_nbits(torch.arange(ALPHABET, device=dev))[None, :].to(torch.float32)
    pos_grid = torch.from_numpy(_POS_GRID).to(dev)
    lut = sym_bits.reshape(3, 63, ALPHABET)[:, pos_grid].reshape(3, 8, 8, ALPHABET)
    lut[:, 0, 0, :] = 0.0
    return lut


def _pos_grid() -> np.ndarray:
    """[64] zigzag position - 1 of each flat storage slot (0 for the DC slot)."""
    inv = np.argsort(zigzag_order(8, 8))  # flat index -> zigzag position
    return np.maximum(inv - 1, 0).astype(np.int64)


_POS_GRID = _pos_grid()


def predict_lcol(v: torch.Tensor) -> torch.Tensor:
    """Causal 2D prediction of a per-block integer field ([nby, nbx]): the
    first column predicts from above, the rest from the left."""
    v = v.to(torch.int64)
    pred = F.pad(v, (1, 0))[:, :-1].clone()
    pred[:, 0] = F.pad(v, (0, 0, 1, 0))[:-1, 0]
    return v - pred


def image_to_blocks(planes: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """[3, H, W] -> edge-padded [3, hp // 8, wp // 8, 8, 8] (a view of
    `planes` when it is already hp x wp)."""
    h, w = planes.shape[-2:]
    if (h, w) != (hp, wp):
        planes = F.pad(planes[None], (0, wp - w, 0, hp - h), mode="replicate")[0]
    return planes.reshape(3, hp // 8, 8, wp // 8, 8).permute(0, 1, 3, 2, 4)


def dc_predict_residual(dcq: torch.Tensor) -> torch.Tensor:
    """r = q - W - N + NW over [3, nby, nbx] (unclamped gradient predictor)."""
    w = F.pad(dcq, (1, 0))[:, :, :-1]
    n = F.pad(dcq, (0, 0, 1, 0))[:, :-1, :]
    nw = F.pad(dcq, (1, 0, 1, 0))[:, :-1, :-1]
    return dcq - w - n + nw


def _ac_counts4(ac_tok: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """[3, 63, NNZ_Q, A] AC token counts by (channel, position, bucket)."""
    nb = ac_tok.shape[1]
    dev = ac_tok.device
    c = torch.arange(3, device=dev)[:, None, None]
    p = torch.arange(63, device=dev)[None, None, :]
    idx = ((c * 63 + p) * NNZ_Q + qb.to(torch.int64)[:, :, None]) * ALPHABET + ac_tok.to(torch.int64)
    counts = torch.bincount(idx.reshape(-1), minlength=3 * 63 * NNZ_Q * ALPHABET)
    return counts.reshape(3, 63, NNZ_Q, ALPHABET)


def _histogram_stepped(tokp: torch.Tensor, step_ctx: torch.Tensor, lanes: int, n_ctx: int) -> torch.Tensor:
    """Exact per-context histogram [n_ctx, A] of a padded stream whose
    context is constant within each K-token step (an integer bincount)."""
    idx = torch.repeat_interleave(step_ctx.to(torch.int64), lanes) * ALPHABET + tokp.to(torch.int64)
    return torch.bincount(idx, minlength=n_ctx * ALPHABET).reshape(n_ctx, ALPHABET)


def ac_step_ctx(lay, q_sorted: torch.Tensor) -> torch.Tensor:
    """[T - t_a] per-AC-step context ids: the nnz-conditioned (channel,
    position, bucket) of each step's first token. Shared encoder/decoder
    ground truth."""
    chan = lay["ac_step_chan"].astype(np.int64)
    pos = lay["ac_step_pos"].astype(np.int64)
    base = CTX_AC_BASE + chan * 63 + (pos - 1)
    flat_idx = chan * lay["nb"] + lay["ac_step_blk"]
    dev = q_sorted.device
    qs = q_sorted.reshape(-1)[torch.from_numpy(flat_idx).to(dev)]
    return torch.from_numpy(base).to(dev) + qs.to(torch.int64) * (3 * 63)


def bucket_perm(q_final: torch.Tensor, nb: int) -> torch.Tensor:
    """[3, nb] stable bucket-sort permutation of the block axis (keys are
    distinct, so the order is unique)."""
    keys = q_final.to(torch.int64) * nb + torch.arange(nb, device=q_final.device)[None, :]
    return torch.argsort(keys, dim=1)


def _step_ctx_v8(lay, q_sorted: torch.Tensor) -> torch.Tensor:
    """[T] per-step context ids: static for phase A, nnz-conditioned AC."""
    static_a = torch.from_numpy(lay["step_ctx"][: lay["t_a"]].astype(np.int64)).to(q_sorted.device)
    return torch.cat([static_a, ac_step_ctx(lay, q_sorted)])


def _small_hist_bits(v: torch.Tensor, levels: int) -> torch.Tensor:
    """Exact entropy (bits) of each row of small-alphabet ids v [3, n]."""
    oh = (v[..., None] == torch.arange(levels, device=v.device)).to(torch.float32)
    return torch.sum(_entropy_bits(torch.sum(oh, dim=1)))


def tokens_from_rgb(
    rgb: torch.Tensor, distance: float, *, height: int, width: int, effort: int = 7,
    hook_a: int = 0, hook_b: bool = False, knobs=Knobs,
):
    """Pixels (u8 [H, W, 3] tensor) -> (token, nbits, mantissa [n_tokens]
    int32, params int, q_sorted [3, nb], values [n_tokens] int32).

    hook_a / hook_b: the strategy's homogeneity hooks (`Strategy.hook_a`,
    `Strategy.hook_b`; see strategy.acs.search_acs). The encode reads a few
    decisions back to the host (DC mode, map prediction, nnz and EPF bits),
    so it synchronises with the device.

    params: bits 0-1 DC predictor, 2-4 causal ACS / QF / nnz map
    prediction, 5 the adaptive-EPF decision (the container's mode field).
    Effort gates as in the reference: e2 DC predictor search, e3 CfL +
    adaptive quant + EPF decision, e4 sub-8 search, e5 RDO, e6/e7 merges,
    e8 a second pass whose ACS search and RDO cost every coefficient by
    the measured rate under the first pass's histograms (`_bits_lut_grid`)
    and the 128 merge, e9 the 256 merge."""
    dev = rgb.device
    lay = token_layout(height, width)
    nby, nbx, nb = lay["nby"], lay["nbx"], lay["nb"]
    hp, wp = lay["hp"], lay["wp"]
    img = rgb.to(torch.float32) / 255.0
    xyb = srgb_to_xyb(img)
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    planes = torch.stack([x, y, b - y])
    planes_p = F.pad(planes[None], (0, wp - width, 0, hp - height), mode="replicate")[0]
    blocks = image_to_blocks(planes_p, hp, wp)

    if effort >= 3:
        qf_idx = quant_field(planes_p[1])
    else:
        qf_idx = torch.full((nby, nbx), QF_CENTER_IDX, dtype=torch.int64, device=dev)
    qf_mul = qf_multiplier(qf_idx)

    def one_pass(bit_lut):
        acs, raw, qsteps = search_acs(
            blocks, planes_p, distance, effort=effort, qf_mul=qf_mul,
            hook_a=hook_a, hook_b=hook_b, hooka_eps=knobs.hooka_eps, bit_lut=bit_lut,
        )

        def quant(v, steps, channel):
            if effort >= 5:
                return _quantize_ac_rdo(v, steps, knobs.rdo_kappa, bit_lut, channel)
            return _quantize_ac(v, steps, knobs.deadzone)

        # chroma-from-luma against the decoder-matched (dequantised) luma
        qy = quant(raw[1], qsteps[1], 1)
        yd = dequant_ac_biased(qy, qsteps[1])
        ty, tx = lay["ty"], lay["tx"]
        if effort >= 3:

            def tile_sum(v):
                vp = F.pad(v, (0, 0, 0, 0, 0, tx * 4 - nbx, 0, ty * 4 - nby))
                return vp.reshape(ty, 4, tx, 4, 8, 8).sum(dim=(1, 3, 4, 5))

            den = tile_sum(yd * yd) + 1e-9
            cfl_idx, resids = [], {}
            for c in (0, 2):
                k = torch.clamp(tile_sum(raw[c] * yd) / den, -1.0, 1.0)
                idx = torch.round(k * 32.0).to(torch.int32)
                kq = idx.to(torch.float32) / 32.0
                kb = torch.repeat_interleave(torch.repeat_interleave(kq, 4, dim=0), 4, dim=1)[:nby, :nbx]
                resids[c] = raw[c] - kb[:, :, None, None] * yd
                cfl_idx.append(idx.reshape(-1))
        else:
            cfl_idx = [torch.zeros(ty * tx, dtype=torch.int32, device=dev) for _ in range(2)]
            resids = {0: raw[0], 2: raw[2]}
        qstorage = torch.stack([quant(resids[0], qsteps[0], 0), qy, quant(resids[2], qsteps[2], 2)])

        # DC plane: exact 8x8 block means * 8 for every strategy
        dc_step = dc_steps_t(distance, device=dev)
        dc8 = blocks.mean(dim=(-2, -1)) * 8.0
        dcq = torch.round(dc8 / dc_step[:, None, None]).to(torch.int64)
        if effort >= 2:
            w_ = F.pad(dcq, (1, 0))[:, :, :-1]
            n_ = F.pad(dcq, (0, 0, 1, 0))[:, :-1, :]
            nw_ = F.pad(dcq, (1, 0, 1, 0))[:, :-1, :-1]
            res_all = torch.stack([dcq, dcq - w_, dcq - w_ - n_ + nw_])
            dc_mode = int(torch.argmin(torch.sum(_bits_proxy(res_all), dim=(1, 2, 3))))
            dc_res = res_all[dc_mode]
        else:
            dc_mode = 2
            dc_res = dc_predict_residual(dcq)

        ac_zz = permute_last(qstorage.reshape(3, nb, 64), lay["zigzag"])[..., 1:]

        def map_field(v):
            """Causal residuals when they proxy-cost less than the raw ids."""
            raw_ids = v.reshape(-1).to(torch.int32)
            res = zigzag_map(predict_lcol(v).reshape(-1))
            on = bool(torch.sum(_bits_proxy(res)) < torch.sum(_bits_proxy(raw_ids)))
            return (res if on else raw_ids), int(on)

        acs_tok, acs_on = map_field(acs)
        qf_tok, qf_on = map_field(qf_idx)

        # nnz-bucket conditioning: on only when the exact conditional entropy
        # plus the map's signalling cost beats the marginal by the margin
        nnz = torch.sum(ac_zz != 0, dim=-1)
        qb = torch.zeros_like(nnz)
        for e in NNZ_EDGES:
            qb = qb + (nnz >= e).to(qb.dtype)
        av = zigzag_map(ac_zz)  # [3, nb, 63]
        ac_tok_ids, _, _ = tokenize(av)
        counts4 = _ac_counts4(ac_tok_ids, qb)
        h_cond = torch.sum(_entropy_bits(counts4))
        h_marg = torch.sum(_entropy_bits(counts4.sum(dim=2)))
        qmap = qb.reshape(3, nby, nbx)
        qres = zigzag_map(torch.stack([predict_lcol(qmap[c]) for c in range(3)]).reshape(3, -1))
        sig = torch.minimum(_small_hist_bits(qb, NNZ_Q), _small_hist_bits(qres, 2 * NNZ_Q))
        nnz_cond_on = bool((h_cond + sig + knobs.nnz_margin) < h_marg)
        if knobs.nnz_force is not None:
            nnz_cond_on = knobs.nnz_force
        q_final = qb if nnz_cond_on else torch.zeros_like(qb)

        qf3 = q_final.reshape(3, nby, nbx)
        nnz_res = zigzag_map(torch.stack([predict_lcol(qf3[c]) for c in range(3)]).reshape(-1))
        nnz_raw = q_final.reshape(-1).to(torch.int32)
        nnz_on = bool(torch.sum(_bits_proxy(nnz_res)) < torch.sum(_bits_proxy(nnz_raw)))
        nnz_tok = nnz_res if nnz_on else nnz_raw

        perm = bucket_perm(q_final, nb)
        av_sorted = torch.gather(av, 1, perm[:, :, None].expand(3, nb, 63))
        q_sorted = torch.gather(q_final, 1, perm)

        params = dc_mode | (acs_on << 2) | (qf_on << 3) | (int(nnz_on) << 4)
        values = torch.cat(
            [
                acs_tok,
                qf_tok,
                zigzag_map(torch.cat(cfl_idx)),
                nnz_tok,
                zigzag_map(dc_res.reshape(-1)),
                av_sorted.transpose(1, 2).reshape(-1),  # z-major over sorted blocks
            ]
        )
        token, nbits, mant = tokenize(values)
        return token, nbits, mant, params, q_sorted, counts4, values

    token, nbits, mant, params, q_sorted, counts4, values = one_pass(None)
    if effort >= 8:
        # two-pass rate model: search and quantise again with the measured
        # per-symbol costs under the first pass's own AC histograms
        token, nbits, mant, params, q_sorted, _c4, values = one_pass(_bits_lut_grid(counts4.sum(dim=2)))

    if effort >= 3:
        # adaptive EPF: filter only when the decoder-side reconstruction
        # (merged groups as sub-8 slots, 2x2-pooled) gets closer to the
        # source by a 0.4% SSE margin
        dec_params = (
            (params & 3) | 0b100 | (((params >> 2) & 1) << 3)
            | (((params >> 3) & 1) << 4) | (((params >> 4) & 1) << 5)
        )
        rec_planes, eff_mul = _reconstruct(
            values, distance, dec_params, height=height, width=width,
            epf=False, return_planes=True, skip_merged=True,
        )
        filtered = epf_apply(rec_planes, eff_mul, distance)
        h2, w2 = (height // 2) * 2, (width // 2) * 2

        def pool(p):
            return p[:, :h2, :w2].reshape(3, h2 // 2, 2, w2 // 2, 2).mean(dim=(2, 4))

        img_pooled = pool(img.permute(2, 0, 1)).permute(1, 2, 0)

        def rgb_err(p):
            q = pool(p)
            srgb = xyb_to_srgb(torch.stack([q[0], q[1], q[2] + q[1]], dim=-1))
            return torch.sum((srgb - img_pooled) ** 2)

        epf_bit = int(bool(rgb_err(filtered) < 0.996 * rgb_err(rec_planes)))
    else:
        epf_bit = 1
    if knobs.epf_force is not None:
        epf_bit = int(knobs.epf_force)
    params = params | (epf_bit << 5)
    return token, nbits, mant, params, q_sorted, values




def _modular_candidate(rgb: np.ndarray, mode: int) -> bool:
    """Host pre-screen: could the modular path beat VarDCT on this image?
    The fraction of pixels equal to both their west and north neighbours
    (~0 on photographic content, large on text / graphics)."""
    if mode == 0:
        return False
    if mode >= 2:
        return True
    a = np.asarray(rgb)
    if a.ndim != 3 or a.shape[0] < 2 or a.shape[1] < 2:
        return False
    if a.shape[0] * a.shape[1] > (1 << 24):
        a = a[::4, ::4]
    eqw = (a[:, 1:] == a[:, :-1]).all(axis=2)
    eqn = (a[1:, :] == a[:-1, :]).all(axis=2)
    return float(np.mean(eqw[1:, :] & eqn[:, 1:])) >= 0.12



def _with(x: torch.Tensor, idx, val) -> torch.Tensor:
    out = x.clone()
    out[idx] = val
    return out


def blocks_to_image(blocks: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[3, nby, nbx, 8, 8] -> [3, height, width] (crop padding)."""
    nby, nbx = blocks.shape[1], blocks.shape[2]
    planes = blocks.permute(0, 1, 3, 2, 4).reshape(3, nby * 8, nbx * 8)
    return planes[:, :height, :width]


def _reconstruct_sub8(storage: torch.Tensor, dc: torch.Tensor, acs: torch.Tensor) -> torch.Tensor:
    """Pixel blocks for strategies 0..3, selected per block by the acs map.
    storage: [3, nby, nbx, 8, 8] dequantised coefficients, dc: [3, nby, nbx]."""
    lead = storage.shape[:-2]
    out8 = idct2d(_with(storage, (..., 0, 0), dc))

    m = torch.stack(
        [
            torch.stack([dc, storage[..., 0, 4]], dim=-1),
            torch.stack([storage[..., 4, 0], storage[..., 4, 4]], dim=-1),
        ],
        dim=-2,
    )
    subdc = idct2d(m)
    q44 = storage.reshape(*lead, 2, 4, 2, 4).permute(0, 1, 2, 3, 5, 4, 6)
    p44 = idct2d(_with(q44, (..., 0, 0), subdc))
    out44 = p44.permute(0, 1, 2, 3, 5, 4, 6).reshape(*lead, 8, 8)

    m1h = storage[..., 0, 4]
    h84 = storage.reshape(*lead, 8, 2, 4).permute(0, 1, 2, 4, 3, 5).clone()
    h84[..., 0, 0, 0] = (dc + m1h) / _SQRT2
    h84[..., 1, 0, 0] = (dc - m1h) / _SQRT2
    out84 = idct2d(h84).permute(0, 1, 2, 4, 3, 5).reshape(*lead, 8, 8)

    m1v = storage[..., 4, 0]
    h48 = storage.reshape(*lead, 2, 4, 8).clone()
    h48[..., 0, 0, 0] = (dc + m1v) / _SQRT2
    h48[..., 1, 0, 0] = (dc - m1v) / _SQRT2
    out48 = idct2d(h48).reshape(*lead, 8, 8)

    sel = acs[None, :, :, None, None]
    out = torch.where(sel == ACS_DCT4X4, out44, out8)
    out = torch.where(sel == ACS_DCT8X4, out84, out)
    return torch.where(sel == ACS_DCT4X8, out48, out)


def _overlay_merged(pix, storage, dc, acs, n: int, sid: int):
    """Overwrite the pixels of n x n merged groups; skipped when no group
    uses this size."""
    k = n // 8
    nby, nbx = acs.shape
    gby, gbx = nby // k, nbx // k
    if gby == 0 or gbx == 0:
        return pix
    mask = acs[: gby * k : k, : gbx * k : k] == sid  # group origin blocks
    if not bool(mask.any()):
        return pix
    slots = storage[:, : gby * k, : gbx * k].reshape(3, gby, k, gbx, k, 8, 8).permute(0, 1, 3, 2, 4, 5, 6)
    dcb = dc[:, : gby * k, : gbx * k].reshape(3, gby, k, gbx, k).permute(0, 1, 3, 2, 4)
    tiles = reassemble_merged(slots, dcb)  # [3, gby, gbx, n, n]
    tile_img = tiles.permute(0, 1, 3, 2, 4).reshape(3, gby * n, gbx * n)
    out = pix.clone()
    region = out[:, : gby * n, : gbx * n]
    mask_img = torch.repeat_interleave(torch.repeat_interleave(mask, n, dim=0), n, dim=1)
    out[:, : gby * n, : gbx * n] = torch.where(mask_img[None], tile_img, region)
    return out


def unpredict_lcol(res: torch.Tensor) -> torch.Tensor:
    """Inverse of codec.encode.predict_lcol: the first column is a downward
    prefix sum, then every row a rightward prefix sum."""
    col0 = torch.cumsum(res[:, :1], dim=0)
    return torch.cumsum(torch.cat([col0, res[:, 1:]], dim=1), dim=1)


def _nnz_map_from_padded(vals_a: torch.Tensor, params: int, lay):
    """Decoded phase-A padded values -> (q_final [3, nb], q_sorted [3, nb]):
    reads the nnz-bucket section at its padded span offsets, undoes the
    (flag-selected) causal prediction, clips to the bucket range, and
    applies the shared stable bucket sort."""
    nby, nbx = lay["nby"], lay["nbx"]
    pred_on = (params >> 5) & 1
    chans = []
    for i in range(3):
        _c, dst, n_real, _p = lay["spans"][3 + i]  # nnz spans follow CfL
        sec = vals_a[dst : dst + n_real]
        if pred_on:
            v = unpredict_lcol(zigzag_unmap(sec).to(torch.int64).reshape(nby, nbx))
        else:
            v = sec.to(torch.int64).reshape(nby, nbx)
        chans.append(torch.clamp(v, 0, NNZ_Q - 1).reshape(-1))
    q_final = torch.stack(chans)
    q_sorted = torch.gather(q_final, 1, bucket_perm(q_final, lay["nb"]))
    return q_final, q_sorted


def _reconstruct(
    values: torch.Tensor, distance, params: int, *, height: int, width: int,
    epf: bool = True, return_planes: bool = False, skip_merged: bool = False,
):
    """Decoded value stream [n_tokens] -> RGB u8 [H, W, 3] (dequant, IDCT,
    CfL, EPF, colourspace).

    params (JxtHeader.decode_params): bits 0-1 DC predictor mode, bit 2 AC
    reconstruction bias, bits 3/4/5 causal ACS / QF / nnz map prediction,
    bit 6 EPF. return_planes=True stops before EPF and returns (padded XYB
    planes [3, hp, wp] with B as Y-residual, eff_mul [nby, nbx]);
    skip_merged leaves merged groups as their sub-8 slots (the encoder's
    EPF decision uses that cheaper reconstruction)."""
    lay = token_layout(height, width)
    dev = values.device
    signed = zigzag_unmap(values).to(torch.int64)
    dc_mode = params & 3
    bias_on = (params >> 2) & 1

    n_acs, n_qf, n_cfl, n_dc = lay["n_acs"], lay["n_qf"], lay["n_cfl"], lay["n_dc"]
    nb, nby, nbx = lay["nb"], lay["nby"], lay["nbx"]
    ty, tx = lay["ty"], lay["tx"]

    def field(start, n, levels, pred_bit):
        if (params >> pred_bit) & 1:
            v = unpredict_lcol(signed[start : start + n].reshape(nby, nbx))
        else:
            v = values[start : start + n].to(torch.int64).reshape(nby, nbx)
        return torch.clamp(v, 0, levels - 1)

    acs = field(0, n_acs, N_STRATEGIES, 3)
    qf_mul = qf_multiplier(field(n_acs, n_qf, QF_LEVELS, 4))
    cfl = signed[n_acs + n_qf : n_acs + n_qf + n_cfl].reshape(2, ty, tx)

    nnz_start = n_acs + n_qf + n_cfl
    q_final = torch.stack([field(nnz_start + c * nb, nb, NNZ_Q, 5).reshape(-1) for c in range(3)])
    inv_perm = torch.argsort(bucket_perm(q_final, nb), dim=1)

    dc_start = nnz_start + lay["n_nnz"]
    dc_res = signed[dc_start : dc_start + n_dc].reshape(3, nby, nbx)
    if dc_mode == 0:
        dcq = dc_res
    elif dc_mode == 1:
        dcq = torch.cumsum(dc_res, dim=2)
    else:
        dcq = torch.cumsum(torch.cumsum(dc_res, dim=2), dim=1)

    ac_sorted = signed[dc_start + n_dc :].reshape(3, 63, nb).transpose(1, 2)
    ac = torch.gather(ac_sorted, 1, inv_perm[:, :, None].expand(3, nb, 63))
    acq_zz = torch.cat([torch.zeros((3, nb, 1), dtype=torch.int64, device=dev), ac], dim=-1)
    acq = permute_last(acq_zz, inverse_zigzag_order(8, 8)).reshape(3, nby, nbx, 8, 8)

    dc = dcq.to(torch.float32) * dc_steps_t(distance, device=dev)[:, None, None]
    eff_mul = effective_multiplier(qf_mul, acs)
    qsteps = steps_field(distance, acs, eff_mul)
    acf = acq.to(torch.float32)
    acf = acf - (bias_on * ac_recon_bias()) * torch.sign(acf)
    storage = acf * qsteps

    # chroma-from-luma: add back the signalled per-tile luma prediction
    yd = storage[1]
    kq = torch.clamp(cfl.to(torch.float32), -32, 32) / 32.0
    kb = torch.repeat_interleave(torch.repeat_interleave(kq, 4, dim=1), 4, dim=2)[:, :nby, :nbx]
    storage = torch.stack(
        [storage[0] + kb[0][:, :, None, None] * yd, yd, storage[2] + kb[1][:, :, None, None] * yd]
    )

    planes = blocks_to_image(_reconstruct_sub8(storage, dc, acs), nby * 8, nbx * 8)
    if not skip_merged:
        for n, sid, _min_eff in MERGE_LADDER:
            planes = _overlay_merged(planes, storage, dc, acs, n, sid)
    if return_planes:
        return planes, eff_mul
    if epf and (params >> 6) & 1:
        # the reference's form planes + on * (filtered - planes), at on = 1
        planes = planes + (epf_apply(planes, eff_mul, distance) - planes)
    planes = planes[:, :height, :width]
    x, y, b_res = planes[0], planes[1], planes[2]
    srgb = xyb_to_srgb(torch.stack([x, y, b_res + y], dim=-1))
    return torch.round(srgb * 255.0).to(torch.uint8)
