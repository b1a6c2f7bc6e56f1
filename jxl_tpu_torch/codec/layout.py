"""Static token/context layout — shared encoder/decoder ground truth.

Port of `jxl_tpu/codec/layout.py` (numpy only, copied so the port never
imports jax). See the reference module for the stream order and the
two-phase (static sections, then nnz-conditioned AC) design.

Token stream order (flat index -> meaning):
  [0, nb)            AC-strategy map tokens ([nby, nbx])
  [nb, 2*nb)         quant-field multiplier indices ([nby, nbx])
  [.., +2*ntiles)    chroma-from-luma factors, zigzag-mapped ([2, ty, tx])
  [.., +3*nb)        nnz-bucket map ([3, nby, nbx], values 0..NNZ_Q-1)
  [.., +3*nb)        DC residual tokens, channel-major ([3, nby, nbx])
  [.., end)          AC tokens, [3, 63, nb], block axis bucket-sorted

`padded_layout` pads every span to a multiple of the lane count K, so each
K-token scan step has a single context. The layout functions keep a
BOUNDED cache: the container reader validates header geometry in closed
form (`layout_counts`) and never builds a layout for untrusted input.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from jxl_tpu_torch.transforms.dct import zigzag_order

_BAND_EDGES = (2, 4, 8, 16, 32)
N_BANDS = len(_BAND_EDGES) + 1

NNZ_Q = 4
NNZ_EDGES = (1, 3, 8)

# Context ids: 0-2 DC (X, Y, B), 3 ACS map, 4 QF map, 5 CfL, 6-8 nnz map
# (X, Y, B), 9.. AC: 9 + (bucket * 3 + c) * 63 + (p - 1).
CTX_ACS = 3
CTX_QF = 4
CTX_CFL = 5
CTX_NNZ = 6  # .. 8
CTX_AC_BASE = 9
N_CTX = CTX_AC_BASE + 3 * 63 * NNZ_Q  # 765
CFL_TILE = 4  # chroma-from-luma tile size in 8x8 blocks (32x32 pixels)

# lossless per-8x8-block activity classes (codec/lossless.py)
LL_Q = 3
LL_EDGES = (1, 33)

_CACHE = 16  # layouts kept per function: a few image geometries per process


@lru_cache(maxsize=1)
def ac_band_table() -> np.ndarray:
    """[63] band index for zigzag positions 1..63."""
    pos = np.arange(1, 64)
    band = np.zeros(63, np.int32)
    for e in _BAND_EDGES:
        band += (pos >= e).astype(np.int32)
    return band


def layout_counts(height: int, width: int, lossless: bool) -> tuple[int, int]:
    """(n_tokens, n_ctx) of an image geometry in closed form — O(1) time
    and memory, for validating untrusted container headers."""
    hp = -(-height // 8) * 8
    wp = -(-width // 8) * 8
    nb = (hp // 8) * (wp // 8)
    if lossless:
        return 3 * nb + 3 * hp * wp, 3 + 3 * LL_Q
    ty, tx = -(-(hp // 8) // CFL_TILE), -(-(wp // 8) // CFL_TILE)
    # ACS + QF maps, CfL, nnz map, DC, AC
    return 2 * nb + 2 * ty * tx + 3 * nb + 3 * nb + 3 * 63 * nb, N_CTX


@lru_cache(maxsize=_CACHE)
def token_layout(height: int, width: int):
    """Geometry + context ids for an image (python ints and numpy arrays).

    `ctx` holds per-token context ids with AC buckets as 0 — the layout's
    static view; bucket-conditioned ids are computed from the nnz map
    (`codec.encode.ac_step_ctx`)."""
    hp = -(-height // 8) * 8
    wp = -(-width // 8) * 8
    nby, nbx = hp // 8, wp // 8
    nb = nby * nbx
    n_acs = nb
    n_qf = nb
    ty, tx = -(-nby // CFL_TILE), -(-nbx // CFL_TILE)
    n_cfl = 2 * ty * tx
    n_nnz = 3 * nb
    n_dc = 3 * nb
    n_ac = 3 * nb * 63
    n_tokens = n_acs + n_qf + n_cfl + n_nnz + n_dc + n_ac

    band = ac_band_table()
    runs = [(CTX_ACS, n_acs), (CTX_QF, n_qf), (CTX_CFL, n_cfl)]
    runs += [(CTX_NNZ + c, nb) for c in range(3)]
    runs += [(c, nb) for c in range(3)]  # DC
    band_start = []  # first zigzag position (1-indexed) of each band
    for b in range(N_BANDS):
        band_start.append(int(np.argmax(band == b)) + 1)
    for c in range(3):
        for b in range(N_BANDS):
            nominal = CTX_AC_BASE + c * 63 + (band_start[b] - 1)
            runs.append((nominal, int(np.sum(band == b)) * nb))
    ac_pos_ctx = np.repeat(CTX_AC_BASE + np.arange(3 * 63, dtype=np.int32), nb)
    ctx = np.concatenate(
        [
            np.full(n_acs, CTX_ACS, np.int32),
            np.full(n_qf, CTX_QF, np.int32),
            np.full(n_cfl, CTX_CFL, np.int32),
            np.repeat(np.arange(CTX_NNZ, CTX_NNZ + 3, dtype=np.int32), nb),
            np.repeat(np.arange(3, dtype=np.int32), nb),
            ac_pos_ctx,
        ]
    )
    zz = zigzag_order(8, 8)  # [64] flat indices, zz[0] == 0 (DC)

    return {
        "runs": runs,
        "hp": hp,
        "wp": wp,
        "nby": nby,
        "nbx": nbx,
        "nb": nb,
        "n_acs": n_acs,
        "n_qf": n_qf,
        "n_cfl": n_cfl,
        "n_nnz": n_nnz,
        "ty": ty,
        "tx": tx,
        "n_dc": n_dc,
        "n_ac": n_ac,
        "n_tokens": n_tokens,
        "n_ctx": N_CTX,
        "ctx": ctx,
        "zigzag": zz,
    }


def _pad_runs(runs, lanes: int):
    """Pad every (ctx, n) run to a multiple of `lanes` so each K-token scan
    step has a single context."""
    spans = []
    dst = 0
    step_ctx = []
    for c, n in runs:
        n_pad = -(-n // lanes) * lanes
        spans.append((c, dst, n, n_pad))
        step_ctx += [c] * (n_pad // lanes)
        dst += n_pad
    return spans, dst, np.asarray(step_ctx, dtype=np.int32)


@lru_cache(maxsize=_CACHE)
def lossless_layout(height: int, width: int, lanes: int):
    """Token layout of the lossless modular mode (v8): per-(channel, 8x8
    block) activity flags first, then the three residual planes 8-padded,
    block-major, activity-sorted. Contexts: 0-2 flag maps, 3 + q * 3 + c
    pixels."""
    hp = -(-height // 8) * 8
    wp = -(-width // 8) * 8
    nbl = (hp // 8) * (wp // 8)
    n_pix = hp * wp
    runs = [(c, nbl) for c in range(3)]
    runs += [(3 + c, n_pix) for c in range(3)]  # nominal q=0 ctx
    spans, dst, step_ctx = _pad_runs(runs, lanes)
    t_a = sum(n_pad for _c, _d, _n, n_pad in spans[:3]) // lanes

    chan_l, blk_l = [], []
    for (c0, _d, n_real, n_pad), c in zip(spans[3:], range(3)):
        for s in range(n_pad // lanes):
            o = min(s * lanes, n_real - 1)
            chan_l.append(c)
            blk_l.append(o // 64)
    return {
        "runs": runs,
        "spans": spans,
        "hp": hp,
        "wp": wp,
        "nbl": nbl,
        "n_tokens": 3 * nbl + 3 * n_pix,
        "n_padded": dst,
        "T": dst // lanes,
        "t_a": t_a,
        "n_ctx": 3 + 3 * LL_Q,
        "step_ctx": step_ctx,
        "ll_step_chan": np.asarray(chan_l, np.int32),
        "ll_step_blk": np.asarray(blk_l, np.int32),
    }


@lru_cache(maxsize=_CACHE)
def padded_layout(height: int, width: int, lanes: int):
    """K-padded token layout for the grouped rANS coder.

    Returns token_layout's dict plus:
      n_padded      total padded tokens (= T * lanes)
      T             scan steps
      step_ctx      [T] int32 static context id per step
      ctx_padded    [n_padded] int32 per-token context ids
      spans         (ctx, dst_start, n_real, n_run_padded) per run
      t_a           steps of phase A (maps, CfL, nnz map, DC)
      ac_step_chan/pos/blk  [T - t_a] channel, zigzag position (1..63)
                    and sorted-block index of each AC step's first token
    """
    base = token_layout(height, width)
    spans, dst, step_ctx = _pad_runs(base["runs"], lanes)
    out = dict(base)
    out["spans"] = spans
    out["n_padded"] = dst
    out["T"] = dst // lanes
    out["step_ctx"] = step_ctx
    out["ctx_padded"] = np.repeat(step_ctx, lanes)

    n_a_spans = 9
    t_a = sum(n_pad for _c, _d, _n, n_pad in spans[:n_a_spans]) // lanes
    out["t_a"] = t_a

    nb = base["nb"]
    band = ac_band_table()
    chan_l, pos_l, blk_l = [], [], []
    for (nominal, _d, n_real, n_pad), (c, b) in zip(
        spans[n_a_spans:], [(c, b) for c in range(3) for b in range(N_BANDS)]
    ):
        band_positions = np.nonzero(band == b)[0] + 1  # 1-indexed zigzag
        for s in range(n_pad // lanes):
            o = min(s * lanes, n_real - 1)
            chan_l.append(c)
            pos_l.append(int(band_positions[o // nb]))
            blk_l.append(o % nb)
    out["ac_step_chan"] = np.asarray(chan_l, np.int32)
    out["ac_step_pos"] = np.asarray(pos_l, np.int32)
    out["ac_step_blk"] = np.asarray(blk_l, np.int32)
    return out
