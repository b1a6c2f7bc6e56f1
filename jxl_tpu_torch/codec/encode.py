"""JXT encoder, VarDCT single-image path (port of `jxl_tpu/codec/encode.py`).

  sRGB u8 -> XYB -> (B -= Y) -> pad -> 8x8 blocks -> AC-strategy search
  (sub-8 transforms and the 16/32/64 merges) -> RDO quantisation + CfL ->
  adaptive DC prediction -> causal map prediction -> nnz-bucket
  conditioning -> hybrid-uint tokens -> K-padded runs -> stepped
  histogram -> k-means clustering -> 12-bit tables -> grouped rANS encode
  kernel -> container bytes.

All per-pixel and per-symbol work runs as torch ops on the given device;
the rANS encode is the CUDA kernel of `entropy/cuda_rans_enc.py` on a GPU.
`encode_image` takes an explicit `device`; `resolve_device` turns TF32 off
there on CUDA (the DCTs and the k-means cost matrix stay full float32).
The kernel's buckets go straight to container bytes: one device-to-host
copy each of the counts, words, mantissa bytes, states and tables.

Covered: lossy VarDCT, efforts 1-7, BASELINE strategy. Not ported yet,
and raising NotImplementedError: d = 0 lossless, modular-lossy and
palette modes (including the modular candidate an image with flat
synthetic content gets when `config.modular`), efforts 8-9, the
homogeneity strategies, grid and batched encodes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from jxl_tpu_torch.codec.config import CodecConfig, Strategy
from jxl_tpu_torch.codec.container import MAX_PIXELS, JxtHeader, JxtStream, write_container
from jxl_tpu_torch.codec.layout import CTX_AC_BASE, NNZ_EDGES, NNZ_Q, padded_layout, token_layout
from jxl_tpu_torch.core.device import resolve_device
from jxl_tpu_torch.core.xyb import srgb_to_xyb, xyb_to_srgb
from jxl_tpu_torch.entropy.cluster import _entropy_bits, cluster_histograms_kmeans
from jxl_tpu_torch.entropy.cuda_rans_enc import enc_caps, encode_grouped_cuda
from jxl_tpu_torch.entropy.grouped import GROUP, kernel_rows
from jxl_tpu_torch.entropy.rans import exclusive_cumsum, quantize_histograms_t
from jxl_tpu_torch.entropy.tokens import ALPHABET, tokenize, zigzag_map
from jxl_tpu_torch.strategy.acs import log2_1p_fast, search_acs
from jxl_tpu_torch.transforms.adaptive import QF_CENTER_IDX, qf_multiplier, quant_field
from jxl_tpu_torch.transforms.dct import permute_last
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
    (they change the bitstream; the decoder does not read them).

    deadzone    AC zero-bin widening in step units (efforts <= 4)
    rdo_kappa   rate weight of the RDO quantiser (efforts >= 5)
    nnz_margin  bits the nnz conditioning must save to switch on
    nnz_force   pin the nnz-conditioning decision (None = measured)
    epf_force   pin the adaptive-EPF decision (None = measured)
    modular     modular-candidate mode: 0 off, 1 auto, 2 force
    """

    deadzone: float = 0.12
    rdo_kappa: float = 0.12
    nnz_margin: float = 768.0
    nnz_force: bool | None = None
    epf_force: bool | None = None
    modular: int = 1


def encoder_knobs() -> EncoderKnobs:
    """Read the knobs from the environment."""
    mod = os.environ.get("JXL_TPU_MODULAR")
    return EncoderKnobs(
        deadzone=float(os.environ.get("JXL_TPU_DEADZONE", "0.12")),
        rdo_kappa=float(os.environ.get("JXL_TPU_RDO_KAPPA", "0.12")),
        nnz_margin=float(os.environ.get("JXL_TPU_NNZ_MARGIN", "768")),
        nnz_force=_env_force("JXL_TPU_NNZ_FORCE"),
        epf_force=_env_force("JXL_TPU_EPF_FORCE"),
        modular=1 if mod is None or mod == "" else int(mod),
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


def _quantize_ac_rdo(x: torch.Tensor, steps: torch.Tensor, kappa: float) -> torch.Tensor:
    """RDO AC quantisation (efforts >= 5): per coefficient, the nearest level
    q0 or its toward-zero neighbour, whichever minimises
    (t - recon(q))^2 + kappa * bits(q), with the decoder's biased recon."""
    t = x / steps
    q0 = torch.round(t).to(torch.int32)
    q1 = q0 - torch.sign(q0)
    b = ac_recon_bias()

    def recon(q):
        qf = q.to(torch.float32)
        return qf - b * torch.sign(qf)

    c0 = (t - recon(q0)) ** 2 + kappa * _bits_proxy(q0)
    c1 = (t - recon(q1)) ** 2 + kappa * _bits_proxy(q1)
    return torch.where(c1 < c0, q1, q0)


def predict_lcol(v: torch.Tensor) -> torch.Tensor:
    """Causal 2D prediction of a per-block integer field ([nby, nbx]): the
    first column predicts from above, the rest from the left."""
    v = v.to(torch.int64)
    pred = F.pad(v, (1, 0))[:, :-1].clone()
    pred[:, 0] = F.pad(v, (0, 0, 1, 0))[:-1, 0]
    return v - pred


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
    knobs: EncoderKnobs | None = None,
):
    """Pixels (u8 [H, W, 3] tensor) -> (token, nbits, mantissa [n_tokens]
    int32, params int, q_sorted [3, nb], values [n_tokens] int32).

    params: bits 0-1 DC predictor, 2-4 causal ACS / QF / nnz map
    prediction, 5 the adaptive-EPF decision (the container's mode field).
    Effort gates as in the reference: e2 DC predictor search, e3 CfL +
    adaptive quant + EPF decision, e4 sub-8 search, e5 RDO, e6/e7 merges."""
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
    blocks = planes_p.reshape(3, nby, 8, nbx, 8).permute(0, 1, 3, 2, 4)

    if effort >= 3:
        qf_idx = quant_field(planes_p[1])
    else:
        qf_idx = torch.full((nby, nbx), QF_CENTER_IDX, dtype=torch.int64, device=dev)
    qf_mul = qf_multiplier(qf_idx)

    acs, raw, qsteps = search_acs(blocks, planes_p, distance, effort=effort, qf_mul=qf_mul)

    def quant(v, steps):
        if effort >= 5:
            return _quantize_ac_rdo(v, steps, knobs.rdo_kappa)
        return _quantize_ac(v, steps, knobs.deadzone)

    # chroma-from-luma against the decoder-matched (dequantised) luma
    qy = quant(raw[1], qsteps[1])
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
    qstorage = torch.stack([quant(resids[0], qsteps[0]), qy, quant(resids[2], qsteps[2])])

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


def entropy_inputs(token: torch.Tensor, mant: torch.Tensor, step_ctx: torch.Tensor, lay, lanes: int):
    """K-pad the token stream per the layout's spans, histogram it under the
    per-step contexts, cluster + quantise the tables.

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
    cmap, ctables = cluster_histograms_kmeans(counts, k=min(K_CLUSTERS, n_ctx))
    freq_k, _ = quantize_histograms_t(ctables)
    freq = freq_k[cmap]
    rows = kernel_rows(step_ctx, freq, exclusive_cumsum(freq, dim=1))
    return tokp, mantp, rows, freq


def _entropy_and_pack(token: torch.Tensor, mant: torch.Tensor, step_ctx: torch.Tensor, lay, lanes: int):
    """Entropy-code the token stream with the rANS encode kernel and bring
    the container pieces to the host.

    Returns (freq [n_ctx, A] u32, states [lanes] u32, words bytes (u16 LE),
    mantissa bytes, wcounts [G] u32, mcounts [G] u32)."""
    T = lay["T"]
    tokp, mantp, rows, freq = entropy_inputs(token, mant, step_ctx, lay, lanes)
    capw, capm = enc_caps(T, lanes)
    words, mbytes, states, wcounts, mcounts = encode_grouped_cuda(
        tokp, mantp, rows, T=T, lanes=lanes, capw=capw, capm=capm
    )
    wc, mc = torch.stack([wcounts, mcounts]).cpu().numpy().astype(np.int64)
    G = lanes // GROUP
    cw, cm = words.shape[1], mbytes.shape[1]
    words_used = torch.cat([words[g, cw - wc[g] :] for g in range(G)]).cpu().numpy()
    mant_used = torch.cat([mbytes[g, cm - mc[g] :] for g in range(G)]).cpu().numpy()
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
    wcounts, mcounts, params=2,
) -> bytes:
    """Container bytes of a lossy VarDCT stream. EPF is on only when both
    the config allows it and the encoder's measured decision (params bit
    5) says it helps; params bits 0-5 go to flags bits 2-7."""
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
        flags=(1 if (config.epf and config.distance > 0.0 and ((int(params) >> 5) & 1)) else 0)
        | ((int(params) & 0x3F) << 2),
    )
    stream = JxtStream(
        header=header,
        freq=freq_np.astype(np.uint32),
        states=states_np.astype(np.uint32),
        stream_words=words_b,
        mant_bytes=mant_b,
        wcounts=np.asarray(wcounts, dtype=np.uint32),
        mcounts=np.asarray(mcounts, dtype=np.uint32),
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


def encode_image(rgb: np.ndarray, config: CodecConfig, orig_name: str = "", *, device) -> bytes:
    """Encode an RGB u8 [H, W, 3] image to JXT bytes, computing on `device`.

    Lossy distances are floored at 0.05 as in the reference. Raises
    NotImplementedError for what the port does not cover yet (see the
    module docstring) rather than coding it another way."""
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    if h * w > MAX_PIXELS:
        raise ValueError(
            f"{h}x{w} exceeds the {MAX_PIXELS}-pixel single-section cap "
            "(the JXTS striped format is not ported to jxl_tpu_torch yet)"
        )
    if config.distance <= 0.0:
        raise NotImplementedError("d = 0 lossless / palette modes (codec/lossless.py) are not ported yet")
    if config.effort >= 8:
        raise NotImplementedError("efforts 8-9 (measured-rate two-pass search, 128/256 merges) are not ported yet")
    if config.strategy is not Strategy.BASELINE:
        raise NotImplementedError(f"strategy {config.strategy.name} (strategy/homogeneity.py) is not ported yet")
    knobs = encoder_knobs()
    if config.modular and _modular_candidate(rgb, knobs.modular):
        raise NotImplementedError(
            "this image is a modular-mode candidate; the modular-lossy encode and the "
            "VarDCT-vs-modular pick are not ported yet (pass CodecConfig(modular=False))"
        )
    if config.distance < 0.05:
        config = replace(config, distance=0.05)
    dev = resolve_device(device)
    lanes = pick_lanes(token_layout(h, w)["n_tokens"], config.lanes)
    lay = padded_layout(h, w, lanes)
    rgb_t = torch.from_numpy(np.ascontiguousarray(rgb, dtype=np.uint8)).to(dev)
    token, _nbits, mant, params, q_sorted, _values = tokens_from_rgb(
        rgb_t, config.distance, height=h, width=w, effort=int(config.effort), knobs=knobs
    )
    pieces = _entropy_and_pack(token, mant, _step_ctx_v8(lay, q_sorted), lay, lanes)
    return _assemble_container(h, w, config, orig_name, lanes, lay, *pieces, params=params)


def encode_image_grid(rgb, config: CodecConfig, distances, orig_name: str = "", *, device):
    raise NotImplementedError("grid encode (one program over an RD row) is not ported to jxl_tpu_torch yet")


def encode_images(jobs, *, device):
    raise NotImplementedError("batched multi-image encode is not ported to jxl_tpu_torch yet")
