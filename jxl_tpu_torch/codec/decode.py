"""JXT decoder (port of `jxl_tpu/codec/decode.py`).

Container bytes -> (host) parse -> one upload of the per-group word and
mantissa buckets -> the grouped rANS decode kernel in two phases joined by
its carry -> reconstruction as torch ops on the same device:
- VarDCT streams: phase A the maps, CfL, nnz map and DC; phase B the AC,
  whose per-step contexts come from the nnz map phase A decoded; then
  dequant, IDCT ladder, CfL, EPF and XYB -> sRGB;
- modular streams (flag bit 1: lossless, modular-lossy, palette): phase A
  the per-block activity maps; phase B the residual planes, whose contexts
  come from those maps (`_ll_phase_b_ctx`); then the prefix-sum inverse
  predictors, dequant by the header distance's step law and YCoCg-R ->
  RGB, or the palette gather (`codec/lossless.py:reconstruct_lossless`).

A single stream decodes through kernel B1 (`decode_grouped_cuda`). A grid
row — same-geometry streams of one coding family, such as one image's
RD-sweep points — decodes through kernel B2 (`decode_grouped_batched_cuda`):
one launch per phase for the whole row, then reconstruction stream by
stream. Palette streams and mixed rows decode stream by stream.

Entry points take an explicit `device`; `resolve_device` turns TF32 off
there on CUDA. A striped JXTS container (magic `JXTS`) goes from
`decode_bytes[_device]` / `decode_file` to `codec/tiled.py`, which decodes
its sections here (`decode_stream_planes` for the VarDCT ones) and
stitches them.
"""

from __future__ import annotations

import numpy as np
import torch

from jxl_tpu_torch.codec.container import JxtStream, read_container
from jxl_tpu_torch.codec.encode import ac_step_ctx, bucket_perm
from jxl_tpu_torch.codec.layout import LL_Q, NNZ_Q, lossless_layout, padded_layout, token_layout
from jxl_tpu_torch.codec.lossless import ll_step_ctx, reconstruct_lossless
from jxl_tpu_torch.codec.tiled import decode_striped_device, is_striped
from jxl_tpu_torch.core.device import resolve_device
from jxl_tpu_torch.core.xyb import xyb_to_srgb
from jxl_tpu_torch.entropy.cuda_rans import decode_grouped_batched_cuda, decode_grouped_cuda
from jxl_tpu_torch.entropy.grouped import GROUP, kernel_rows
from jxl_tpu_torch.entropy.rans import exclusive_cumsum
from jxl_tpu_torch.entropy.tokens import zigzag_unmap
from jxl_tpu_torch.strategy.acs import (
    ACS_DCT4X4,
    ACS_DCT4X8,
    ACS_DCT8X4,
    MERGE_LADDER,
    N_STRATEGIES,
    effective_multiplier,
    reassemble_merged,
    steps_field,
)
from jxl_tpu_torch.transforms.adaptive import QF_LEVELS, qf_multiplier
from jxl_tpu_torch.transforms.dct import idct2d, inverse_zigzag_order, permute_last
from jxl_tpu_torch.transforms.epf import epf_apply
from jxl_tpu_torch.transforms.quant import ac_recon_bias, dc_steps_t

_SQRT2 = float(np.sqrt(2.0))


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


def _stream_buffers(stream: JxtStream, capw: int, capm: int):
    """(words [G, capw], mant [G, capm]) int32 numpy: each group's segment
    at the front of its row, zero tail (caps >= the largest group's
    counts)."""
    G = stream.header.lanes // GROUP
    words = np.frombuffer(stream.stream_words, dtype="<u2")
    mant = np.frombuffer(stream.mant_bytes, dtype=np.uint8)
    wc = stream.wcounts.astype(np.int64)
    mc = stream.mcounts.astype(np.int64)
    wg = np.zeros((G, capw), np.int32)
    mg = np.zeros((G, capm), np.int32)
    wb = np.concatenate([[0], np.cumsum(wc)])
    mb = np.concatenate([[0], np.cumsum(mc)])
    for g in range(G):
        wg[g, : wc[g]] = words[wb[g] : wb[g + 1]]
        mg[g, : mc[g]] = mant[mb[g] : mb[g + 1]]
    return wg, mg


def _layout(header):
    """The padded layout of a stream's coding family and geometry."""
    if header.lossless:
        return lossless_layout(header.height, header.width, header.lanes)
    return padded_layout(header.height, header.width, header.lanes)


def _ll_phase_b_ctx(vals_a: torch.Tensor, lay) -> torch.Tensor:
    """Modular phase-B step contexts from the decoded activity maps (phase
    A's three flag spans, clipped to the class range)."""
    flags = [vals_a[dst : dst + n_real] for _c, dst, n_real, _p in lay["spans"][:3]]
    q = torch.clamp(torch.stack(flags).to(torch.int64), 0, LL_Q - 1)
    q_sorted = torch.gather(q, 1, bucket_perm(q, lay["nbl"]))
    return ll_step_ctx(lay, q_sorted)[lay["t_a"] :]


def _phase_b_ctx(vals_a: torch.Tensor, header, lay) -> torch.Tensor:
    if header.lossless:
        return _ll_phase_b_ctx(vals_a, lay)
    _qf, q_sorted = _nnz_map_from_padded(vals_a, header.decode_params, lay)
    return ac_step_ctx(lay, q_sorted)


def _scan_one(words_g, mant_g, states, rows, ptrs, *, T: int, lanes: int):
    """Kernel B1 in the batched calling convention, for one stream."""
    v, st, p = decode_grouped_cuda(words_g, mant_g, states[0], rows[:, 0], ptrs, T=T, lanes=lanes)
    return v[None], st[None], p


def _padded_values(streams, dev: torch.device, scan) -> torch.Tensor:
    """Both rANS phases of same-geometry streams of one coding family ->
    padded value streams [B, n_padded] int32 on `dev`.

    `scan` runs one phase for all streams with decode_grouped_batched's
    arguments: `_scan_one` (kernel B1) for a single stream,
    `decode_grouped_batched_cuda` (kernel B2, one launch per phase) for a
    row. The word and mantissa buckets of all streams go up in one upload
    each, with caps equal to the largest counts across the row."""
    h = streams[0].header
    lanes = h.lanes
    G = lanes // GROUP
    B = len(streams)
    lay = _layout(h)
    t_a, T = lay["t_a"], lay["T"]
    capw = max(1, max(int(s.wcounts.max()) for s in streams))
    capm = max(1, max(int(s.mcounts.max()) for s in streams))
    bufs = [_stream_buffers(s, capw, capm) for s in streams]
    words_g = torch.from_numpy(np.concatenate([b[0] for b in bufs])).to(dev)
    mant_g = torch.from_numpy(np.concatenate([b[1] for b in bufs])).to(dev)
    states = torch.from_numpy(np.stack([np.asarray(s.states, np.int64) for s in streams])).to(dev)
    freqs = [torch.from_numpy(np.asarray(s.freq, np.int64)).to(dev).to(torch.int32) for s in streams]
    cums = [exclusive_cumsum(f, dim=1) for f in freqs]
    ptrs = torch.zeros((2, B * G), dtype=torch.int32, device=dev)

    step_ctx_a = torch.from_numpy(lay["step_ctx"][:t_a]).to(dev)
    rows_a = torch.stack([kernel_rows(step_ctx_a, f, c) for f, c in zip(freqs, cums)], dim=1)
    vals_a, st, ptrs = scan(words_g, mant_g, states, rows_a, ptrs, T=t_a, lanes=lanes)
    rows_b = [kernel_rows(_phase_b_ctx(vals_a[i], s.header, lay), freqs[i], cums[i]) for i, s in enumerate(streams)]
    vals_b, _st, _ptrs = scan(words_g, mant_g, st, torch.stack(rows_b, dim=1), ptrs, T=T - t_a, lanes=lanes)
    return torch.cat([vals_a, vals_b], dim=1)


def _unpad(values_p: torch.Tensor, lay) -> torch.Tensor:
    """[..., n_padded] -> [..., n_tokens]: drop the K-padding of each span."""
    return torch.cat([values_p[..., dst : dst + n_real] for _c, dst, n_real, _p in lay["spans"]], dim=-1)


def decode_values(stream: JxtStream, device) -> torch.Tensor:
    """The decoded value stream [n_tokens] int32 (K-padding removed) of a
    container: both rANS phases (kernel B1), on `device`."""
    dev = resolve_device(device)
    values_p = _padded_values([stream], dev, _scan_one)[0]
    return _unpad(values_p, _layout(stream.header))


def decode_values_grid(streams, device) -> torch.Tensor:
    """The decoded value streams [N, n_tokens] int32 of a uniform row of
    containers (same height, width, lanes and coding family): both rANS
    phases for the whole row in one kernel-B2 launch each, on `device`."""
    dev = resolve_device(device)
    if not _same_geometry(streams):
        raise ValueError("decode_values_grid takes streams of one height, width, lane count and coding family")
    return _unpad(_padded_values(streams, dev, decode_grouped_batched_cuda), _layout(streams[0].header))


def _palette(stream: JxtStream, dev: torch.device):
    """A palette stream's palette as u8 [256, 3] on `dev` (entries past the
    signalled ones are zero), or None for any other stream."""
    if not (stream.header.lossless and len(stream.acs_extra) >= 3):
        return None
    pal = np.zeros((256, 3), np.uint8)
    p = np.frombuffer(stream.acs_extra, np.uint8).reshape(-1, 3)
    pal[: len(p)] = p
    return torch.from_numpy(pal).to(dev)


def _reconstruct_stream(values: torch.Tensor, stream: JxtStream) -> torch.Tensor:
    """A stream's decoded values -> RGB u8 [H, W, 3] on values' device."""
    h = stream.header
    if h.lossless:
        return reconstruct_lossless(
            values, h.decode_params, height=h.height, width=h.width, distance=h.distance,
            pal=_palette(stream, values.device),
        )
    return _reconstruct(values, h.distance, h.decode_params, height=h.height, width=h.width)


def decode_stream_device(stream: JxtStream, *, device) -> torch.Tensor:
    """JxtStream -> RGB u8 [H, W, 3] tensor on `device`."""
    return _reconstruct_stream(decode_values(stream, device), stream)


def decode_stream(stream: JxtStream, *, device) -> np.ndarray:
    """JxtStream -> RGB u8 [H, W, 3] numpy array."""
    return decode_stream_device(stream, device=device).cpu().numpy()


def decode_stream_planes(stream: JxtStream, *, device):
    """A VarDCT JxtStream -> (pre-EPF padded XYB planes [3, hp, wp] with B
    as Y-residual, eff_mul [nby, nbx]) on `device`: what the striped
    decoder (codec/tiled.py) stitches before its one EPF pass."""
    h = stream.header
    return _reconstruct(
        decode_values(stream, device), h.distance, h.decode_params, height=h.height, width=h.width,
        epf=False, return_planes=True,
    )


def decode_bytes_device(data: bytes, *, device) -> torch.Tensor:
    """Decode container bytes (a single section, or a striped JXTS
    container) to an RGB u8 [H, W, 3] tensor on `device`."""
    if is_striped(data):
        return decode_striped_device(data, device=device)
    return decode_stream_device(read_container(data), device=device)


def decode_bytes(data: bytes, *, device) -> np.ndarray:
    """Decode container bytes to an RGB u8 [H, W, 3] numpy array (the work
    runs on `device`)."""
    return decode_bytes_device(data, device=device).cpu().numpy()


def _same_geometry(streams) -> bool:
    """Every stream has the first's height, width, lane count and coding
    family."""
    h0 = streams[0].header
    return all(
        (s.header.height, s.header.width, s.header.lanes, s.header.lossless)
        == (h0.height, h0.width, h0.lanes, h0.lossless)
        for s in streams
    )


def _uniform_row(streams) -> bool:
    """Whether a row decodes as one batch: more than one stream, all of one
    geometry, and no palette stream (those need a per-stream palette
    gather). EPF may differ per point: each stream's decode-params bit
    governs it."""
    return (
        len(streams) > 1
        and _same_geometry(streams)
        and not any(s.header.lossless and len(s.acs_extra) >= 3 for s in streams)
    )


def decode_bytes_grid_stacked(datas, *, device):
    """Decode a grid row (container bytes of same-geometry streams, such as
    one image's RD-sweep points) to an RGB u8 [N, H, W, 3] tensor on
    `device`: both rANS phases in one kernel-B2 launch each for the whole
    row, then reconstruction stream by stream.

    Returns None when the row is a single stream or is not uniform
    (geometry, lanes or coding family differ, or a palette stream or a
    striped JXTS container is in it): callers decode those per stream. A
    uniform modular row (lossless or modular-lossy points) batches like a
    VarDCT row."""
    if any(is_striped(b) for b in datas):
        return None
    streams = [read_container(b) for b in datas]
    if not _uniform_row(streams):
        return None
    values = decode_values_grid(streams, device)
    return torch.stack([_reconstruct_stream(values[i], s) for i, s in enumerate(streams)])


def decode_bytes_grid_device(datas, *, device) -> list:
    """List view of decode_bytes_grid_stacked: [H, W, 3] u8 tensors on
    `device`, one per stream; a row that is not uniform decodes stream by
    stream."""
    out = decode_bytes_grid_stacked(datas, device=device)
    if out is None:
        return [decode_bytes_device(b, device=device) for b in datas]
    return list(out.unbind(0))


def decode_file(path: str, *, device) -> np.ndarray:
    """Decode a .jxt file to an RGB u8 [H, W, 3] numpy array (the work
    runs on `device`)."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), device=device)
