"""Grouped-stream rANS coder — the plain torch versions of the two kernels.

Port of `jxl_tpu/entropy/grouped.py`. A group is 128 adjacent rANS lanes.
The layout (`codec.layout.padded_layout`) gives every K-token scan step ONE
context, so each step reads one (freq | cum) table row (`kernel_rows`).
Group g's words and mantissa bytes are stored in that group's own
consumption order, so a step reads a contiguous run at the group's stream
pointer, distributed by intra-group rank.

These functions are the plain versions of the CUDA kernels in
`entropy/cuda_rans.py` (decode) and `entropy/cuda_rans_enc.py` (encode):
same arguments, same outputs, bit for bit. They run on any device; the
kernel wrappers use them for CPU tensors, and the tests and
`chip_smoke.py` compare the kernels with them. The scans are Python loops
over the steps, vectorised over lanes. State maths runs in int64, masked
to 32 bits where the reference's uint32 arithmetic wraps.

Tensor conventions (shared with the kernels):
  rows    [>= T, 128] int32: lanes 0..63 freq, 64..127 cum (cum = M past
          the alphabet, so the symbol search never lands there)
  words   [G, capw] int32 u16 values;  mbytes [G, capm] int32 byte values
  states  [lanes] int64 in [0, 2^32)
  ptrs    [2, G] int32 word / mantissa-byte stream pointers (decode carry)
The batched decode (`decode_grouped_batched`) stacks B streams along the
group axis (words [B*G, capw], ptrs [2, B*G]) and gives each its own rows
(rows [>= T, B, 128], states [B, lanes]).
"""

from __future__ import annotations

import torch

from jxl_tpu_torch.entropy.rans import (
    RANS_L,
    RANS_M,
    RANS_PRECISION,
    exclusive_cumsum,
)
from jxl_tpu_torch.entropy.tokens import token_nbits

GROUP = 128  # lanes per group
MAX_NBYTES = 3
_U32 = 0xFFFFFFFF


def n_groups(lanes: int) -> int:
    if lanes % GROUP:
        raise ValueError(f"lane count {lanes} is not a multiple of {GROUP}")
    return lanes // GROUP


def kernel_rows(step_ctx: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """[T, 128] int32 row stream: an integer row gather of the per-context
    tables (lanes 0..63 freq, 64..127 cum; slots past the alphabet read as
    freq 0 / cum M)."""
    T = step_ctx.shape[0]
    a = freq.shape[1]
    idx = step_ctx.to(torch.int64)
    rows = torch.zeros((T, 128), dtype=torch.int32, device=freq.device)
    rows[:, 64:] = RANS_M
    rows[:, :a] = freq.to(torch.int32)[idx]
    rows[:, 64 : 64 + a] = cum.to(torch.int32)[idx]
    return rows


def _mant_nbytes(tok: torch.Tensor) -> torch.Tensor:
    """Mantissa bytes a token carries: ceil(nbits / 8)."""
    return (token_nbits(tok) + 7) >> 3


def _backfill_positions(units: torch.Tensor, cap: int):
    """units [T, G, 128] (words or bytes each element emits) -> (first
    in-bucket position of each element's run [T, G, 128], counts [G]).

    The encoder walks the steps back to front and fills each group's bucket
    from its end, so the finished bucket holds the group's stream at
    [cap - count, cap) in decoder consumption order: forward steps, lanes
    in order within a step. Positions below 0 mean the bucket overflowed."""
    rank = exclusive_cumsum(units, dim=2)
    row_tot = units.sum(dim=2)
    row_off = exclusive_cumsum(row_tot, dim=0)
    counts = row_off[-1] + row_tot[-1]
    pos = (cap - counts)[None, :, None] + row_off[:, :, None] + rank
    return pos, counts


def rans_encode_grouped(tokp: torch.Tensor, rows: torch.Tensor, lanes: int, capw: int):
    """rANS-encode a padded token stream [T*lanes] (step t codes under
    rows[t]). Returns (words [G, capw] int32 back-filled buckets, wcounts
    [G] int32, states [lanes] int64). Counts past capw signal overflow;
    nothing is written outside a bucket."""
    G = n_groups(lanes)
    T = tokp.shape[0] // lanes
    tok = tokp.reshape(T, lanes).to(torch.int64)
    r = rows[:T].to(torch.int64)
    f_all = torch.gather(r, 1, tok)
    c_all = torch.gather(r, 1, tok + 64)
    x = torch.full((lanes,), RANS_L, dtype=torch.int64, device=tokp.device)
    words = torch.empty((T, lanes), dtype=torch.int64, device=tokp.device)
    emits = torch.empty((T, lanes), dtype=torch.bool, device=tokp.device)
    for t in range(T - 1, -1, -1):
        f = f_all[t]
        emit = (x >> 20) >= f
        words[t] = x & 0xFFFF
        emits[t] = emit
        x = torch.where(emit, x >> 16, x)
        x = (((x // f) << RANS_PRECISION) + x % f + c_all[t]) & _U32
    pos, counts = _backfill_positions(emits.reshape(T, G, GROUP).to(torch.int64), capw)
    flat = (torch.arange(G, device=tokp.device)[None, :, None] * capw + pos).reshape(T, lanes)
    ok = emits & (pos.reshape(T, lanes) >= 0)
    out = torch.zeros(G * capw, dtype=torch.int32, device=tokp.device)
    out[flat[ok]] = words[ok].to(torch.int32)
    return out.reshape(G, capw), counts.to(torch.int32), x


def pack_mantissa_grouped(tokp: torch.Tensor, mant: torch.Tensor, lanes: int, capm: int):
    """Mantissa bytes (little-endian within a value, ceil(nbits/8) per
    token) in per-group consumption order, back-filled like the words.
    Returns (mbytes [G, capm] int32, mcounts [G] int32)."""
    G = n_groups(lanes)
    T = tokp.shape[0] // lanes
    nbyt = _mant_nbytes(tokp.to(torch.int64)).reshape(T, G, GROUP)
    pos, counts = _backfill_positions(nbyt, capm)
    gbase = torch.arange(G, device=tokp.device)[None, :, None] * capm
    m = mant.to(torch.int64).reshape(T, G, GROUP)
    out = torch.zeros(G * capm, dtype=torch.int32, device=tokp.device)
    for j in range(MAX_NBYTES):
        ok = (j < nbyt) & (pos + j >= 0)
        out[(gbase + pos + j)[ok]] = ((m >> (8 * j)) & 0xFF)[ok].to(torch.int32)
    return out.reshape(G, capm), counts.to(torch.int32)


def decode_grouped(
    words_g: torch.Tensor,
    mant_g: torch.Tensor,
    states: torch.Tensor,
    rows: torch.Tensor,
    ptrs: torch.Tensor,
    *,
    T: int,
    lanes: int,
):
    """Decode T scan steps of the grouped streams, starting from `states`
    and the stream pointers `ptrs` (zeros at the stream start, or the carry
    of a previous phase). Reads past a bucket's end read 0.

    Returns (values [T*lanes] int32 detokenised values, final states
    [lanes] int64, final ptrs [2, G] int32) — the two-phase carry. The
    one-stream case of `decode_grouped_batched`."""
    vals, st, ptrs_out = decode_grouped_batched(
        words_g, mant_g, states.reshape(1, lanes), rows[:T, None], ptrs, T=T, lanes=lanes
    )
    return vals.reshape(T * lanes), st.reshape(lanes), ptrs_out


def decode_grouped_batched(
    words_g: torch.Tensor,
    mant_g: torch.Tensor,
    states: torch.Tensor,
    rows: torch.Tensor,
    ptrs: torch.Tensor,
    *,
    T: int,
    lanes: int,
):
    """`decode_grouped` over B same-geometry streams at once.

    words_g [B*G, capw] and mant_g [B*G, capm] (stream b's groups are rows
    b*G .. b*G + G - 1; the caps are shared), states [B, lanes] int64, rows
    [>= T, B, 128] int32 (each stream steps through its own tables), ptrs
    [2, B*G] int32. All B*G groups advance together, one step at a time;
    group b*G + g reads row rows[t, b].

    Returns (values [B, T*lanes] int32, final states [B, lanes] int64,
    final ptrs [2, B*G] int32)."""
    G = n_groups(lanes)
    B = states.shape[0]
    NG = B * G
    dev = words_g.device
    capw, capm = words_g.shape[1], mant_g.shape[1]
    wflat = words_g.reshape(-1).to(torch.int64)
    mflat = mant_g.reshape(-1).to(torch.int64)
    wbase = torch.arange(NG, device=dev)[:, None] * capw
    mbase = torch.arange(NG, device=dev)[:, None] * capm
    # flat offset of each group's row within a step's [B, 128] rows
    rbase = (torch.arange(NG, device=dev)[:, None] // G) * GROUP
    x = states.to(torch.int64).reshape(NG, GROUP)
    gptr = ptrs[0].to(torch.int64)
    bptr = ptrs[1].to(torch.int64)
    r = rows[:T].to(torch.int64).reshape(T, B * GROUP)
    vals = torch.empty((T, NG, GROUP), dtype=torch.int64, device=dev)
    for t in range(T):
        row = r[t]
        slot = x & (RANS_M - 1)
        # largest k with cum[k] <= slot: 6-probe binary search over the row
        lo = torch.zeros_like(x)
        for p in (32, 16, 8, 4, 2, 1):
            cand = lo + p
            lo = torch.where(row[rbase + cand + 64] <= slot, cand, lo)
        f = row[rbase + lo]
        x_dec = (f * (x >> RANS_PRECISION) + slot - row[rbase + lo + 64]) & _U32
        need = (x_dec < RANS_L).to(torch.int64)
        idx = gptr[:, None] + exclusive_cumsum(need, dim=1)
        ok = (need == 1) & (idx >= 0) & (idx < capw)
        w = torch.where(ok, wflat[wbase + idx.clamp(0, capw - 1)], 0)
        x = torch.where(need == 1, ((x_dec << 16) | w) & _U32, x_dec)
        gptr = gptr + need.sum(dim=1)

        nbits = torch.where(lo >= 32, lo - 27, 0)
        nbyt = (nbits + 7) >> 3
        bidx = bptr[:, None] + exclusive_cumsum(nbyt, dim=1)
        mval = torch.zeros_like(x)
        for j in range(MAX_NBYTES):
            i = bidx + j
            ok = (j < nbyt) & (i >= 0) & (i < capm)
            mval = mval | (torch.where(ok, mflat[mbase + i.clamp(0, capm - 1)], 0) << (8 * j))
        bptr = bptr + nbyt.sum(dim=1)
        vals[t] = torch.where(lo >= 32, (1 << nbits) + mval, lo)
    values = vals.reshape(T, B, lanes).transpose(0, 1).reshape(B, T * lanes)
    ptrs_out = torch.stack([gptr, bptr]).to(torch.int32)
    return values.to(torch.int32), x.reshape(B, lanes), ptrs_out
