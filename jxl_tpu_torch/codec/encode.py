"""JXT encoder (port of `jxl_tpu/codec/encode.py`).

VarDCT (lossy):
  sRGB u8 -> XYB -> (B -= Y) -> pad -> 8x8 blocks -> AC-strategy search
  (sub-8 transforms and the 16..256 merges) -> RDO quantisation + CfL ->
  adaptive DC prediction -> causal map prediction -> nnz-bucket
  conditioning -> hybrid-uint tokens -> K-padded runs -> stepped
  histogram -> k-means clustering -> 12-bit tables -> grouped rANS encode
  kernel -> container bytes. Efforts 8-9 run the search and RDO twice,
  the second time with measured per-symbol rates.
Modular (d = 0 lossless, modular-lossy, palette; `codec/lossless.py`):
  YCoCg-R (or palette indices) -> per-channel predictor -> activity
  classes -> tokens -> the same entropy tail with the greedy histogram
  merge over its 12 contexts. A lossy encode of flat synthetic content
  (`_modular_candidate`) codes both families and keeps one by measured
  bytes and error (`_pick_mode`); a d = 0 encode of <= 256 colours codes
  the palette too and keeps the smaller.

All per-pixel and per-symbol work runs as torch ops on the given device;
the rANS encode is the CUDA kernel of `entropy/cuda_rans_enc.py` on a GPU
for every family (a mantissa bucket that overflows, as d = 0 streams of
photographic content do, relaunches the kernel with grown caps). Every
entry point takes an explicit `device`; `resolve_device` turns TF32 off
there on CUDA (the DCTs and the k-means cost matrix stay full float32).
The kernel's buckets go straight to container bytes: one device-to-host
copy each of the counts, words, mantissa bytes, states and tables.

Entry points: `encode_image` (one image), `encode_image_grid[_async]`
(one image over an RD-sweep row of distances), `encode_images_batched_async`
(same-geometry lossy images) and `encode_images` (a list of jobs). Every
point of a grid or batch runs the same per-image encode as `encode_image`,
one encode-kernel launch per coded stream, so its container is
byte-identical to `encode_image`'s.

Covered: every effort (1-9), every strategy (BASELINE and the thesis's
homogeneity hooks), and the modular family. An image above
`container.MAX_PIXELS` does not fit one section: `encode_file` writes it
in the striped JXTS format (`codec/tiled.py:encode_image_striped`), and
the single-section entry points raise ValueError naming that function.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.container import MAX_PIXELS, JxtHeader, JxtStream, write_container
from jxl_tpu_torch.codec.layout import CTX_AC_BASE, NNZ_EDGES, NNZ_Q, lossless_layout, padded_layout, token_layout
from jxl_tpu_torch.codec.lossless import MOD_COEFS, _mod_coefs, ll_step_ctx, lossless_tokens
from jxl_tpu_torch.core.device import resolve_device
from jxl_tpu_torch.core.xyb import srgb_to_xyb, xyb_to_srgb
from jxl_tpu_torch.entropy.cluster import _entropy_bits, cluster_histograms, cluster_histograms_kmeans
from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda
from jxl_tpu_torch.entropy.grouped import GROUP, kernel_rows
from jxl_tpu_torch.entropy.rans import RANS_M, exclusive_cumsum, quantize_histograms_t
from jxl_tpu_torch.entropy.tokens import ALPHABET, token_nbits, tokenize, zigzag_map
from jxl_tpu_torch.strategy.acs import log2_1p_fast, lut_bits, search_acs
from jxl_tpu_torch.transforms.adaptive import QF_CENTER_IDX, qf_multiplier, quant_field
from jxl_tpu_torch.transforms.dct import permute_last, zigzag_order
from jxl_tpu_torch.transforms.epf import epf_apply
from jxl_tpu_torch.transforms.quant import ac_recon_bias, dc_steps_t, dequant_ac_biased

K_CLUSTERS = 64  # max signalled cluster tables


def _env_force(name: str):
    v = os.environ.get(name)
    return None if v is None or v == "" else bool(int(v))


@dataclass(frozen=True)
class EncoderKnobs:
    """The reference's encoder-side JXL_TPU_* knobs, read under the same
    names with the same defaults so that parity holds when a user sets them
    (they change the bitstream; the decoder does not read them, except
    JXL_TPU_MOD_Q, which `lossless.modular_steps` reads on both sides).

    deadzone    AC zero-bin widening in step units (efforts <= 4)
    rdo_kappa   rate weight of the RDO quantiser (efforts >= 5)
    nnz_margin  bits the nnz conditioning must save to switch on
    nnz_force   pin the nnz-conditioning decision (None = measured)
    epf_force   pin the adaptive-EPF decision (None = measured)
    modular     modular-candidate mode: 0 off, 1 auto, 2 force
    hooka_eps   near-tie margin of the RD-gated hook A (HOMOGENEITY_RD_GATED)
    no_cluster  one table per context in the small-context (modular) modes
    mod_q       (ky, kc, p) of the modular-lossy step law
    mod_rule    (byte_win, sse_tol, sse_win, byte_tol) of `_pick_mode`
    """

    deadzone: float = 0.12
    rdo_kappa: float = 0.12
    nnz_margin: float = 768.0
    nnz_force: bool | None = None
    epf_force: bool | None = None
    modular: int = 1
    hooka_eps: float = 0.02
    no_cluster: bool = False
    mod_q: tuple = MOD_COEFS
    mod_rule: tuple = (0.5, 3.2, 0.5, 1.2)


def encoder_knobs() -> EncoderKnobs:
    """Read the knobs from the environment."""
    mod = os.environ.get("JXL_TPU_MODULAR")
    rule = os.environ.get("JXL_TPU_MOD_RULE")
    return EncoderKnobs(
        deadzone=float(os.environ.get("JXL_TPU_DEADZONE", "0.12")),
        rdo_kappa=float(os.environ.get("JXL_TPU_RDO_KAPPA", "0.12")),
        nnz_margin=float(os.environ.get("JXL_TPU_NNZ_MARGIN", "768")),
        nnz_force=_env_force("JXL_TPU_NNZ_FORCE"),
        epf_force=_env_force("JXL_TPU_EPF_FORCE"),
        modular=1 if mod is None or mod == "" else int(mod),
        hooka_eps=float(os.environ.get("JXL_TPU_HOOKA_EPS", "0.02")),
        no_cluster=bool(os.environ.get("JXL_TPU_NO_CLUSTER")),
        mod_q=_mod_coefs(),
        mod_rule=tuple(float(x) for x in rule.split(",")) if rule else EncoderKnobs.mod_rule,
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
    hook_a: int = 0, hook_b: bool = False, knobs: EncoderKnobs | None = None,
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
    if knobs is None:
        knobs = encoder_knobs()
    from jxl_tpu_torch.codec.decode import _reconstruct

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


def entropy_inputs(
    token: torch.Tensor, mant: torch.Tensor, step_ctx: torch.Tensor, lay, lanes: int, cluster: bool = True,
):
    """K-pad the token stream per the layout's spans, histogram it under the
    per-step contexts, cluster + quantise the tables: k-means for the v8
    lossy context set (more than K_CLUSTERS contexts), the greedy merge for
    the small-context modular modes, or one table per context there when
    not `cluster` (JXL_TPU_NO_CLUSTER).

    Returns (tokp [T*lanes] int32, mantp [T*lanes] int32, rows [T, 128]
    int32, freq [n_ctx, A] int32): the rANS encode kernel's inputs and the
    tables the container signals."""
    dev = token.device
    n_ctx = lay["n_ctx"]
    tokp = torch.zeros(lay["n_padded"], dtype=torch.int32, device=dev)
    mantp = torch.zeros(lay["n_padded"], dtype=torch.int32, device=dev)
    src = 0
    for _c, dst, n_real, _n_pad in lay["spans"]:
        tokp[dst : dst + n_real] = token[src : src + n_real]
        mantp[dst : dst + n_real] = mant[src : src + n_real]
        src += n_real

    counts = _histogram_stepped(tokp, step_ctx, lanes, n_ctx)
    if n_ctx > K_CLUSTERS:
        cmap, ctables = cluster_histograms_kmeans(counts, k=K_CLUSTERS)
        freq_k, _ = quantize_histograms_t(ctables)
        freq = freq_k[cmap]
    else:
        # merged rows are equal within a cluster; the writer dedupes them
        freq, _ = quantize_histograms_t(cluster_histograms(counts)[0] if cluster else counts)
    rows = kernel_rows(step_ctx, freq, exclusive_cumsum(freq, dim=1))
    return tokp, mantp, rows, freq


def _entropy_encode(
    token: torch.Tensor, mant: torch.Tensor, step_ctx: torch.Tensor, lay, lanes: int, cluster: bool = True,
):
    """Entropy-code the token stream with the rANS encode kernel, leaving
    the results on the device: (freq [n_ctx, A], words [G, capw], mbytes
    [G, capm] back-filled buckets, states [lanes], wcounts [G], mcounts
    [G])."""
    T = lay["T"]
    tokp, mantp, rows, freq = entropy_inputs(token, mant, step_ctx, lay, lanes, cluster)
    capw, capm = enc_caps(T, lanes)
    words, mbytes, states, wcounts, mcounts = encode_grouped_cuda(
        tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm
    )
    return freq, words, mbytes, states, wcounts, mcounts


def _to_host(freq, words, mbytes, states, wcounts, mcounts):
    """Bring `_entropy_encode`'s results to the host as container pieces:
    (freq [n_ctx, A] u32, states [lanes] u32, words bytes (u16 LE),
    mantissa bytes, wcounts [G] u32, mcounts [G] u32)."""
    wc, mc = torch.stack([wcounts, mcounts]).cpu().numpy().astype(np.int64)
    cw, cm = words.shape[1], mbytes.shape[1]
    words_used = torch.cat([words[g, cw - wc[g] :] for g in range(len(wc))]).cpu().numpy()
    mant_used = torch.cat([mbytes[g, cm - mc[g] :] for g in range(len(mc))]).cpu().numpy()
    return (
        freq.cpu().numpy().astype(np.uint32),
        states.cpu().numpy().astype(np.uint32),
        words_used.astype("<u2").tobytes(),
        mant_used.astype(np.uint8).tobytes(),
        wc.astype(np.uint32),
        mc.astype(np.uint32),
    )


def pick_lanes(n_tokens: int, max_lanes: int) -> int:
    """rANS lane count for a stream: each lane costs 4 header bytes, so small
    images use fewer, longer streams (floor: one 128-lane group). The
    default 256 is a sentinel: multi-megapixel streams grow to 512 / 1024
    lanes (>= 6M / 12M tokens); any other explicit value pins the count."""
    if max_lanes == 256:
        if n_tokens >= 12_000_000:
            max_lanes = 1024
        elif n_tokens >= 6_000_000:
            max_lanes = 512
    lanes = max(max_lanes, GROUP)
    while lanes > GROUP and n_tokens // lanes < 512:
        lanes //= 2
    return lanes


def _assemble_container(
    h, w, config, orig_name, lanes, lay, freq_np, states_np, words_b, mant_b,
    wcounts, mcounts, params=2, modular=None, acs_extra=b"",
) -> bytes:
    """Container bytes of one stream. `modular` (default: d <= 0) sets flag
    bit 1, the modular family (lossless, modular-lossy or palette; the
    palette travels in `acs_extra`). EPF is on only for VarDCT streams when
    both the config allows it and the encoder's measured decision (params
    bit 5) says it helps; params bits 0-5 go to flags bits 2-7 (for the
    modular family, the three 2-bit predictor modes)."""
    if modular is None:
        modular = config.distance <= 0.0
    epf = config.epf and not modular and config.distance > 0.0 and (int(params) >> 5) & 1
    header = JxtHeader(
        height=h,
        width=w,
        distance=float(config.distance),
        effort=int(config.effort),
        strategy=int(config.strategy.value),
        orig_name=orig_name,
        lanes=lanes,
        n_tokens=lay["n_tokens"],
        n_ctx=lay["n_ctx"],
        alphabet=ALPHABET,
        flags=(1 if epf else 0) | (2 if modular else 0) | ((int(params) & 0x3F) << 2),
    )
    stream = JxtStream(
        header=header,
        freq=freq_np.astype(np.uint32),
        states=states_np.astype(np.uint32),
        stream_words=words_b,
        mant_bytes=mant_b,
        wcounts=np.asarray(wcounts, dtype=np.uint32),
        mcounts=np.asarray(mcounts, dtype=np.uint32),
        acs_extra=acs_extra,
    )
    return write_container(stream)


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


def _check_size(h: int, w: int):
    if h * w > MAX_PIXELS:
        raise ValueError(
            f"{h}x{w} exceeds the {MAX_PIXELS}-pixel single-section cap: use "
            "codec.tiled.encode_image_striped (the striped JXTS format)"
        )


def _finalizer(h, w, lanes, lay, pending, modular: bool, acs_extra=b""):
    """finalize() -> container bytes of each pending (config, name, params,
    device encode) point, in order."""

    def finalize() -> list:
        return [
            _assemble_container(
                h, w, cfg, name, lanes, lay, *_to_host(*enc), params=params, modular=modular, acs_extra=acs_extra
            )
            for cfg, name, params, enc in pending
        ]

    return finalize


def _encode_points_async(rgbs, config: CodecConfig, distances, orig_names, knobs: EncoderKnobs):
    """VarDCT-encode same-geometry (image tensor, distance, name) points:
    the device work of every point runs now (the per-image encode, one
    encode-kernel launch each); finalize() brings each point's buckets to
    the host and returns its container bytes, in order. Distances are
    floored at 0.05."""
    h, w = int(rgbs[0].shape[0]), int(rgbs[0].shape[1])
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], config.lanes)
    lay = padded_layout(h, w, lanes)
    pending = []
    for rgb_t, d, name in zip(rgbs, distances, orig_names):
        cfg_d = replace(config, distance=max(float(d), 0.05))
        token, _nbits, mant, params, q_sorted, _values = tokens_from_rgb(
            rgb_t, cfg_d.distance, height=h, width=w, effort=int(config.effort),
            hook_a=config.strategy.hook_a, hook_b=config.strategy.hook_b, knobs=knobs,
        )
        enc = _entropy_encode(token, mant, _step_ctx_v8(lay, q_sorted), lay, lanes)
        pending.append((cfg_d, name, params, enc))
    return _finalizer(h, w, lanes, lay, pending, modular=False)


def _modular_layout(h: int, w: int, config: CodecConfig):
    lanes = pick_lanes(3 * h * w, config.lanes)
    return lanes, lossless_layout(h, w, lanes)


def _modular_points_async(rgb_t: torch.Tensor, config: CodecConfig, distances, orig_name: str, knobs: EncoderKnobs):
    """Modular-encode one image (d = 0 lossless or d > 0 modular-lossy,
    `codec/lossless.py`) at each distance as given; the device work runs
    now, finalize() -> list of container bytes."""
    h, w = int(rgb_t.shape[0]), int(rgb_t.shape[1])
    lanes, lay = _modular_layout(h, w, config)
    pending = []
    for d in distances:
        cfg_d = replace(config, distance=float(d))
        token, _nbits, mant, params, q_sorted = lossless_tokens(
            rgb_t, height=h, width=w, distance=cfg_d.distance, coefs=knobs.mod_q
        )
        enc = _entropy_encode(token, mant, ll_step_ctx(lay, q_sorted), lay, lanes, not knobs.no_cluster)
        pending.append((cfg_d, orig_name, params, enc))
    return _finalizer(h, w, lanes, lay, pending, modular=True)


def _modular_async(rgb_t: torch.Tensor, config: CodecConfig, orig_name: str, knobs: EncoderKnobs):
    """One modular encode at config.distance; finalize() -> container bytes."""
    fin = _modular_points_async(rgb_t, config, [config.distance], orig_name, knobs)
    return lambda: fin()[0]


def _modular_grid_async(rgb_t: torch.Tensor, config: CodecConfig, distances, orig_name: str, knobs: EncoderKnobs):
    """The modular family over a sweep row (distances floored at 0.05, as
    the reference's grid does); finalize() -> list of container bytes, each
    byte-identical to `_modular_async` at that distance."""
    return _modular_points_async(rgb_t, config, [max(float(d), 0.05) for d in distances], orig_name, knobs)


def _palette_of(rgb: np.ndarray):
    """Palette detection for the lossless path: with <= 256 distinct RGB
    triples, (palette u8 [N, 3] sorted by luma, index map int32 [H, W]);
    else None. Host numpy, as in the reference."""
    a = np.asarray(rgb)
    if a.ndim != 3 or a.shape[2] != 3:
        return None

    def _pack(x):
        return (
            (x[..., 0].astype(np.uint32) << 16) | (x[..., 1].astype(np.uint32) << 8) | x[..., 2].astype(np.uint32)
        ).reshape(-1)

    if a.shape[0] * a.shape[1] > (1 << 22) and len(np.unique(_pack(a[::4, ::4]))) > 256:
        return None
    colors, inverse = np.unique(_pack(a), return_inverse=True)
    if len(colors) > 256:
        return None
    r = (colors >> 16) & 255
    g = (colors >> 8) & 255
    b = colors & 255
    luma = 0.299 * r + 0.587 * g + 0.114 * b
    order = np.argsort(luma, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    pal = np.stack([r, g, b], axis=1)[order].astype(np.uint8)
    idx = rank[inverse].reshape(a.shape[:2]).astype(np.int32)
    return pal, idx


def _palette_async(idx: np.ndarray, pal: np.ndarray, config: CodecConfig, orig_name: str, knobs: EncoderKnobs, dev):
    """Palette-mode lossless encode: the luma-sorted index plane rides the
    modular machinery as [idx, 0, 0]; the palette travels in the
    container's extra section. finalize() -> container bytes."""
    h, w = int(idx.shape[0]), int(idx.shape[1])
    lanes, lay = _modular_layout(h, w, config)
    idx_t = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(dev)
    z = torch.zeros_like(idx_t)
    token, _nbits, mant, params, q_sorted = lossless_tokens(
        None, height=h, width=w, planes=torch.stack([idx_t, z, z])
    )
    enc = _entropy_encode(token, mant, ll_step_ctx(lay, q_sorted), lay, lanes, not knobs.no_cluster)
    fin = _finalizer(h, w, lanes, lay, [(config, orig_name, params, enc)], modular=True, acs_extra=pal.tobytes())
    return lambda: fin()[0]


def _sse_u8(a: torch.Tensor, b: torch.Tensor) -> float:
    d = a.to(torch.float32) - b.to(torch.float32)
    return float(torch.sum(d * d))


def _pick_mode(rgb_t: torch.Tensor, var_bytes: bytes, mod_bytes: bytes, rule) -> bytes:
    """Per-image coding-mode decision by measured rate and distortion: both
    containers decode on rgb_t's device (float32 SSE, as the reference) and
    the modular one is kept iff it dominates (bytes and SSE both <=
    VarDCT's), or wins big on bytes (<= byte_win x at <= sse_tol x the
    SSE), or on quality (SSE <= sse_win x at <= byte_tol x the bytes).
    rule = (byte_win, sse_tol, sse_win, byte_tol)."""
    from jxl_tpu_torch.codec.decode import decode_bytes_device

    dev = rgb_t.device
    sv = _sse_u8(decode_bytes_device(var_bytes, device=dev), rgb_t)
    sm = _sse_u8(decode_bytes_device(mod_bytes, device=dev), rgb_t)
    rv, rm = len(var_bytes), len(mod_bytes)
    byte_win, sse_tol, sse_win, byte_tol = rule
    pick_mod = (
        (rm <= rv and sm <= sv)
        or (rm <= byte_win * rv and sm <= sse_tol * sv)
        or (sm <= sse_win * sv and rm <= byte_tol * rv)
    )
    return mod_bytes if pick_mod else var_bytes


def _upload(rgb, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.uint8)).to(dev)


def encode_image_async(rgb: np.ndarray, config: CodecConfig, orig_name: str = "", *, device):
    """Dispatch the encode of an RGB u8 [H, W, 3] image on `device` now;
    returns finalize() -> JXT container bytes.

    d <= 0 is the exact lossless modular mode (with `config.modular`, an
    image of <= 256 colours is also coded through the palette and the
    smaller container kept). Lossy distances are floored at 0.05; with
    `config.modular`, flat synthetic content (`_modular_candidate`) is
    also coded modular-lossy and `_pick_mode` keeps one of the two. As in
    encode_image_grid_async, the device work runs before this returns;
    finalize() does the picks and the container assembly."""
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    _check_size(h, w)
    knobs = encoder_knobs()
    dev = resolve_device(device)
    rgb_t = _upload(rgb, dev)
    if config.distance <= 0.0:
        config = replace(config, distance=0.0, epf=False)
        plain_fin = _modular_async(rgb_t, config, orig_name, knobs)
        pal_res = _palette_of(rgb) if config.modular else None
        if pal_res is None:
            return plain_fin
        pal, idx = pal_res
        pal_fin = _palette_async(idx, pal, config, orig_name, knobs, dev)

        def finalize_ll() -> bytes:
            plain_b, pal_b = plain_fin(), pal_fin()
            return pal_b if len(pal_b) < len(plain_b) else plain_b

        return finalize_ll
    config = replace(config, distance=max(float(config.distance), 0.05))
    var_fin = _encode_points_async([rgb_t], config, [config.distance], [orig_name], knobs)
    if not (config.modular and _modular_candidate(rgb, knobs.modular)):
        return lambda: var_fin()[0]
    mod_fin = _modular_async(rgb_t, config, orig_name, knobs)
    return lambda: _pick_mode(rgb_t, var_fin()[0], mod_fin(), knobs.mod_rule)


def encode_image(rgb: np.ndarray, config: CodecConfig, orig_name: str = "", *, device) -> bytes:
    """Encode an RGB u8 [H, W, 3] image to JXT bytes, computing on `device`
    (synchronous form of encode_image_async)."""
    return encode_image_async(rgb, config, orig_name, device=device)()


def encode_image_grid_async(rgb: np.ndarray, config: CodecConfig, distances, orig_name: str = "", *, device):
    """Encode one image at every distance of an RD-sweep row; returns
    finalize() -> list of container bytes (one per distance, same order),
    each byte-identical to `encode_image` at that distance once floored.

    Distances are floored at 0.05, so a d = 0 point is lossy here (the
    modular-lossy family at d = 0.05 is lossless in value on a candidate).
    On a modular candidate each point also codes the modular family and
    keeps one by `_pick_mode`. The device work runs before this returns;
    the port's encode synchronises with the host inside `tokens_from_rgb`,
    so the last copies to the host, the picks and the container assembly
    are left to finalize()."""
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    _check_size(h, w)
    knobs = encoder_knobs()
    dev = resolve_device(device)
    rgb_t = _upload(rgb, dev)
    n = len(distances)
    var_fin = _encode_points_async([rgb_t] * n, config, distances, [orig_name] * n, knobs)
    if not (config.modular and _modular_candidate(rgb, knobs.modular)):
        return var_fin
    mod_fin = _modular_grid_async(rgb_t, config, distances, orig_name, knobs)

    def finalize() -> list:
        return [_pick_mode(rgb_t, v, m, knobs.mod_rule) for v, m in zip(var_fin(), mod_fin())]

    return finalize


def encode_image_grid(rgb: np.ndarray, config: CodecConfig, distances, orig_name: str = "", *, device) -> list:
    """Synchronous form of encode_image_grid_async."""
    return encode_image_grid_async(rgb, config, distances, orig_name, device=device)()


def encode_images_batched_async(rgbs, config: CodecConfig, distances=None, orig_names=None, *, device):
    """Encode a batch of same-geometry images (lossy VarDCT only, no mode
    pick, as in the reference); returns finalize() -> list of container
    bytes, one per image at its distance (default `config.distance`).
    Raises ValueError on a distance <= 0. As in encode_image_grid_async,
    the device work runs before this returns."""
    batch = [np.asarray(r) for r in rgbs]
    h, w = int(batch[0].shape[0]), int(batch[0].shape[1])
    if any(r.shape != batch[0].shape for r in batch):
        raise ValueError("encode_images_batched_async takes images of one geometry")
    if distances is None:
        distances = [config.distance] * len(batch)
    if any(float(d) <= 0.0 for d in distances):
        raise ValueError(
            "encode_images_batched_async is the lossy batch path; d = 0 images go through encode_image"
        )
    if orig_names is None:
        orig_names = [""] * len(batch)
    _check_size(h, w)
    dev = resolve_device(device)
    return _encode_points_async([_upload(r, dev) for r in batch], config, distances, orig_names, encoder_knobs())


def encode_images(jobs, *, device) -> list:
    """Encode [(rgb, config[, orig_name]), ...] one by one; returns the
    container bytes in order."""
    return [encode_image(*job, device=device) for job in jobs]


def encode_file(in_path: str, out_path: str, config: CodecConfig, *, device) -> int:
    """Encode an image file to a .jxt file on `device`; returns the
    compressed size in bytes. An image above the single-section cap is
    written in the striped JXTS format (codec/tiled.py) with the default
    stripe count."""
    from jxl_tpu_torch.core.io import read_image

    rgb = read_image(in_path)
    name = os.path.basename(in_path)
    if int(rgb.shape[0]) * int(rgb.shape[1]) > MAX_PIXELS:
        from jxl_tpu_torch.codec.tiled import encode_image_striped

        data = encode_image_striped(rgb, config, orig_name=name, device=device)
    else:
        data = encode_image(rgb, config, orig_name=name, device=device)
    with open(out_path, "wb") as f:
        f.write(data)
    return len(data)
