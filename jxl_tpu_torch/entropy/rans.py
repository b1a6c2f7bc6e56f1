"""Interleaved rANS coder (port of `jxl_tpu/entropy/rans.py`).

Scheme: 32-bit states, 16-bit renormalisation words, 12-bit frequency
precision. Single-conditional renorm is exact for these parameters
(2^32 >> 16 = 2^16 < f << 20 for all f >= 1).

The standalone coder runs K independent streams in lockstep: symbol i is
coded by lane i % K, and each step of a Python loop over T = ceil(N / K)
steps advances all K states with a few tensor ops, as the reference's
`lax.scan` does (not a kernel: the codec's own scans are the grouped
coder, `entropy/grouped.py`, and its CUDA kernels). Encode walks the steps
in reverse; its words come out in GLOBAL CONSUMPTION ORDER (row-major over
(step, lane) where a renorm fires), so the decoder reads a contiguous
window per step plus a lane-local rank. The reference's uint32 arithmetic
is int64 here, masked to 32 bits where it wraps; words are u16 values held
in int32 tensors, states int64 tensors in [0, 2^32).

The table quantisation and the stream (de)serialisation are the
reference's numpy code, copied.
"""

from __future__ import annotations

import numpy as np
import torch

RANS_PRECISION = 12  # frequency bits; M = 4096
RANS_M = 1 << RANS_PRECISION
RANS_L = 1 << 16  # state lower bound
DEFAULT_LANES = 256
_U32 = 0xFFFFFFFF


def quantize_histograms(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Quantize per-context symbol counts to frequencies summing to 2^12.

    counts: [C, A] nonnegative ints. Returns (freq [C, A], cum [C, A]) uint32.
    Every symbol with a nonzero count gets freq >= 1; the max freq is capped
    at M-1 so that `f << 20` never overflows uint32 in the encoder.
    Deterministic (runs on host; tables are stored in the bitstream header,
    so encoder and decoder always agree).
    """
    counts = np.asarray(counts, dtype=np.int64)
    C, A = counts.shape
    freq = np.zeros((C, A), dtype=np.int64)
    for c in range(C):
        row = counts[c]
        total = row.sum()
        if total == 0:
            # Unused context: put all mass on symbol 0 (capped).
            freq[c, 0] = RANS_M - 1
            freq[c, 1 if A > 1 else 0] += 1
            continue
        f = np.floor(row * (RANS_M / total)).astype(np.int64)
        f[(row > 0) & (f == 0)] = 1
        diff = RANS_M - f.sum()
        # Adjust the largest bucket; it is always big enough to absorb diff.
        f[np.argmax(f)] += diff
        if f.max() >= RANS_M:  # single-symbol context
            j = int(np.argmax(f))
            f[j] = RANS_M - 1
            f[(j + 1) % A] += 1
        assert f.sum() == RANS_M and f.max() < RANS_M and f.min() >= 0
        freq[c] = f
    cum = np.concatenate([np.zeros((C, 1), dtype=np.int64), np.cumsum(freq, axis=1)[:, :-1]], axis=1)
    return freq.astype(np.uint32), cum.astype(np.uint32)


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


def _lane_layout(n: int, lanes: int) -> int:
    """Number of scan steps for n symbols over `lanes` streams."""
    return max(1, -(-n // lanes))


def _int64_on(arrays, device):
    """Tensors or numpy arrays -> int64 tensors on one device: `device` if
    given, else the device of the tensor inputs (numpy input needs
    `device`)."""
    if device is None:
        devs = {a.device for a in arrays if isinstance(a, torch.Tensor)}
        if len(devs) != 1 or not all(isinstance(a, torch.Tensor) for a in arrays):
            raise ValueError("inputs must be tensors on one device, or pass device=")
        device = devs.pop()
    return [
        a.to(device=device, dtype=torch.int64) if isinstance(a, torch.Tensor)
        else torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
        for a in arrays
    ]


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with out-of-range indices clamped, as the reference's gather."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def rans_encode(tokens, ctx_ids, freq, cum, lanes: int = DEFAULT_LANES, *, device=None):
    """Encode tokens [N] (< alphabet) under contexts ctx_ids [N].

    freq / cum: [C, A] quantised tables (from quantize_histograms). Inputs
    are tensors (the device is theirs) or numpy arrays with `device`.
    Returns (words_flat [T * lanes] int32 u16 values in consumption order,
    n_words int32 scalar tensor, states [lanes] int64 final states)."""
    tokens, ctx_ids, freq, cum = _int64_on([tokens, ctx_ids, freq, cum], device)
    dev = tokens.device
    n = tokens.shape[0]
    T = _lane_layout(n, lanes)
    pad = T * lanes - n
    tok = torch.nn.functional.pad(tokens, (0, pad))
    ctx = torch.nn.functional.pad(ctx_ids, (0, pad))
    valid = (torch.arange(T * lanes, device=dev) < n).reshape(T, lanes)
    idx = ctx * freq.shape[1] + tok
    f_all = _gather(freq.reshape(-1), idx).reshape(T, lanes)
    c_all = _gather(cum.reshape(-1), idx).reshape(T, lanes)

    x = torch.full((lanes,), RANS_L, dtype=torch.int64, device=dev)
    words = torch.empty((T, lanes), dtype=torch.int64, device=dev)
    emits = torch.empty((T, lanes), dtype=torch.bool, device=dev)
    for t in range(T - 1, -1, -1):
        f, v = f_all[t], valid[t]
        emit = v & (x >= (f << 20))
        words[t] = x & 0xFFFF
        emits[t] = emit
        xs = torch.where(emit, x >> 16, x)
        # f = 0 (a padding lane, or a token outside its context's support)
        # divides as the reference's uint32 ops do: quotient all ones, remainder 0
        ok = f > 0
        fs = torch.where(ok, f, 1)
        q, r = torch.where(ok, xs // fs, _U32), torch.where(ok, xs % fs, 0)
        x_enc = ((q << RANS_PRECISION) + r + c_all[t]) & _U32
        # padding positions never emit and leave the state unchanged
        x = torch.where(v, x_enc, x)

    # compact the emissions into consumption order: words consumed before
    # this row + this lane's rank among the row's emitters (unique targets;
    # the rest go to one extra slot that is cut off)
    e = emits.to(torch.int64)
    rank_in_row = exclusive_cumsum(e, dim=1)
    row_counts = e.sum(dim=1)
    row_offsets = exclusive_cumsum(row_counts, dim=0)
    n_words = row_offsets[-1] + row_counts[-1]
    target = torch.where(emits, row_offsets[:, None] + rank_in_row, T * lanes)
    out = torch.zeros(T * lanes + 1, dtype=torch.int32, device=dev)
    out[target.reshape(-1)] = words.reshape(-1).to(torch.int32)
    return out[: T * lanes], n_words.to(torch.int32), x


def build_decode_table(freq, cum) -> torch.Tensor:
    """[C, M] int64 fused slot -> (symbol, freq, cum-bias) lookup: symbol in
    bits 0..5, freq in 6..17, bias in 18..29. A slot's symbol is the last
    one whose cum is <= slot (a zero-frequency symbol shares its cum with
    the next, which wins)."""
    freq, cum = freq.to(torch.int64), cum.to(torch.int64)
    C, A = freq.shape
    if A > 64:
        raise ValueError(f"alphabet {A} > 64: the fused table packs the symbol id into 6 bits")
    slots = torch.arange(RANS_M, dtype=torch.int64, device=freq.device).expand(C, RANS_M)
    sym = torch.searchsorted(cum.contiguous(), slots.contiguous(), right=True) - 1
    f_tab = torch.gather(freq, 1, sym)
    bias = torch.gather(cum, 1, sym)
    return sym | (f_tab << 6) | (bias << 18)


def rans_decode(words_flat, states, ctx_ids, freq, cum, n: int, lanes: int = DEFAULT_LANES, *, device=None):
    """Decode n tokens. words_flat: consumption-order u16 words (any
    length: a read past its end sees zeros, and the window start clamps as
    the reference's dynamic_slice does), states: [lanes] final encoder
    states, ctx_ids: [n]. Inputs are tensors or numpy arrays with `device`.
    Returns tokens [n] int32."""
    words_flat, states, ctx_ids, freq, cum = _int64_on([words_flat, states, ctx_ids, freq, cum], device)
    dev = states.device
    T = _lane_layout(n, lanes)
    pad = T * lanes - n
    ctx_all = torch.nn.functional.pad(ctx_ids, (0, pad)).reshape(T, lanes)
    valid = (torch.arange(T * lanes, device=dev) < n).reshape(T, lanes)
    words = torch.nn.functional.pad(words_flat, (0, lanes))
    last_start = words.shape[0] - lanes
    combo_flat = build_decode_table(freq, cum).reshape(-1)

    x = states
    gptr = torch.zeros((), dtype=torch.int64, device=dev)
    syms = torch.empty((T, lanes), dtype=torch.int64, device=dev)
    for t in range(T):
        v = valid[t]
        slot = x & (RANS_M - 1)
        combo = _gather(combo_flat, ctx_all[t] * RANS_M + slot)
        f = (combo >> 6) & 0xFFF
        x_dec = (f * (x >> RANS_PRECISION) + slot - (combo >> 18)) & _U32
        need = v & (x_dec < RANS_L)
        need64 = need.to(torch.int64)
        # the window words[start : start + lanes], start clamped so it fits,
        # read at each needing lane's rank among the step's needers
        w = words[gptr.clamp(0, last_start) + exclusive_cumsum(need64)]
        x_new = torch.where(need, (x_dec << 16) | w, x_dec)
        x = torch.where(v, x_new, x)
        gptr = gptr + need64.sum()
        syms[t] = torch.where(v, combo & 0x3F, 0)
    return syms.reshape(-1)[:n].to(torch.int32)


def serialize_streams(words_flat: np.ndarray, n_words: int) -> bytes:
    """Trim the consumption-order word array to its used prefix (the stream
    IS the serialization — no ragged reassembly needed anymore)."""
    return np.asarray(words_flat)[: int(n_words)].astype("<u2").tobytes()


def deserialize_streams(data: bytes, cap_words: int) -> np.ndarray:
    """Stream bytes -> padded uint16 array of static length cap_words."""
    flat = np.frombuffer(data, dtype="<u2")
    out = np.zeros(cap_words, dtype=np.uint16)
    out[: flat.shape[0]] = flat
    return out
