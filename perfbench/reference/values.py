"""The value stream a container carries, read in plain numpy.

`decode_values_np(streams)` takes parsed VarDCT containers of one geometry
and returns each one's value stream [n_tokens] int32: both rANS phases,
phase B under the contexts that phase A's nnz map gives. It is a numpy
transcription of the program's plain decoder
(`jxl_tpu_torch/entropy/grouped.py:decode_grouped_batched`, which the CUDA
kernels are held to bit for bit), vectorised over the lanes of every stream
at once, and shares no code with the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.codec import _nnz_map_from_padded, ac_step_ctx
from perfbench.reference.layout import padded_layout

GROUP = 128
RANS_PRECISION = 12
RANS_M = 1 << RANS_PRECISION
RANS_L = 1 << 16
MAX_NBYTES = 3
_U32 = 0xFFFFFFFF


def _excl(x: np.ndarray, axis: int) -> np.ndarray:
    return np.cumsum(x, axis=axis) - x


def kernel_rows(step_ctx: np.ndarray, freq: np.ndarray) -> np.ndarray:
    """[T, 128] int64 table rows: lanes 0..63 freq, 64..127 cum (M past the
    alphabet, so the symbol search never lands there)."""
    a = freq.shape[1]
    cum = _excl(freq, 1)
    rows = np.zeros((len(step_ctx), 128), np.int64)
    rows[:, 64:] = RANS_M
    rows[:, :a] = freq[step_ctx]
    rows[:, 64 : 64 + a] = cum[step_ctx]
    return rows


def _buckets(stream, capw: int, capm: int):
    G = stream.header.lanes // GROUP
    words = np.frombuffer(stream.stream_words, dtype="<u2").astype(np.int64)
    mant = np.frombuffer(stream.mant_bytes, dtype=np.uint8).astype(np.int64)
    wc, mc = stream.wcounts.astype(np.int64), stream.mcounts.astype(np.int64)
    wb, mb = np.concatenate([[0], np.cumsum(wc)]), np.concatenate([[0], np.cumsum(mc)])
    wg, mg = np.zeros((G, capw), np.int64), np.zeros((G, capm), np.int64)
    for g in range(G):
        wg[g, : wc[g]] = words[wb[g] : wb[g + 1]]
        mg[g, : mc[g]] = mant[mb[g] : mb[g + 1]]
    return wg, mg


class _Scan:
    """The decode state of B streams of one geometry, stepped phase by
    phase."""

    def __init__(self, streams):
        self.lanes = streams[0].header.lanes
        G = self.lanes // GROUP
        self.B = len(streams)
        NG = self.B * G
        self.capw = max(1, max(int(s.wcounts.max()) for s in streams))
        self.capm = max(1, max(int(s.mcounts.max()) for s in streams))
        bufs = [_buckets(s, self.capw, self.capm) for s in streams]
        self.wflat = np.concatenate([b[0] for b in bufs]).reshape(-1)
        self.mflat = np.concatenate([b[1] for b in bufs]).reshape(-1)
        self.wbase = np.arange(NG)[:, None] * self.capw
        self.mbase = np.arange(NG)[:, None] * self.capm
        self.rbase = (np.arange(NG)[:, None] // G) * GROUP
        self.x = np.stack([np.asarray(s.states, np.int64) for s in streams]).reshape(NG, GROUP)
        self.gptr = np.zeros(NG, np.int64)
        self.bptr = np.zeros(NG, np.int64)

    def run(self, rows: np.ndarray) -> np.ndarray:
        """rows [T, B, 128] -> values [B, T * lanes]."""
        T = rows.shape[0]
        r = rows.reshape(T, self.B * GROUP)
        x, gptr, bptr = self.x, self.gptr, self.bptr
        capw, capm = self.capw, self.capm
        vals = np.empty((T,) + x.shape, np.int32)
        for t in range(T):
            row = r[t]
            slot = x & (RANS_M - 1)
            lo = np.zeros_like(x)
            for p in (32, 16, 8, 4, 2, 1):
                cand = lo + p
                lo = np.where(row[self.rbase + cand + 64] <= slot, cand, lo)
            f = row[self.rbase + lo]
            x_dec = (f * (x >> RANS_PRECISION) + slot - row[self.rbase + lo + 64]) & _U32
            need = (x_dec < RANS_L).astype(np.int64)
            idx = gptr[:, None] + _excl(need, 1)
            ok = (need == 1) & (idx >= 0) & (idx < capw)
            w = np.where(ok, self.wflat[self.wbase + np.clip(idx, 0, capw - 1)], 0)
            x = np.where(need == 1, ((x_dec << 16) | w) & _U32, x_dec)
            gptr = gptr + need.sum(axis=1)

            nbits = np.where(lo >= 32, lo - 27, 0)
            nbyt = (nbits + 7) >> 3
            bidx = bptr[:, None] + _excl(nbyt, 1)
            mval = np.zeros_like(x)
            for j in range(MAX_NBYTES):
                i = bidx + j
                okm = (j < nbyt) & (i >= 0) & (i < capm)
                mval = mval | (np.where(okm, self.mflat[self.mbase + np.clip(i, 0, capm - 1)], 0) << (8 * j))
            bptr = bptr + nbyt.sum(axis=1)
            vals[t] = np.where(lo >= 32, (1 << nbits) + mval, lo)
        self.x, self.gptr, self.bptr = x, gptr, bptr
        return vals.reshape(T, self.B, self.lanes).transpose(1, 0, 2).reshape(self.B, T * self.lanes)


def decode_values_np(streams) -> np.ndarray:
    """Parsed VarDCT containers of one height, width and lane count ->
    their value streams [B, n_tokens] int32 (K-padding removed)."""
    h0 = streams[0].header
    if any(s.header.lossless for s in streams):
        raise ValueError("decode_values_np reads VarDCT streams only")
    if any((s.header.height, s.header.width, s.header.lanes) != (h0.height, h0.width, h0.lanes) for s in streams):
        raise ValueError("decode_values_np takes streams of one geometry")
    lay = padded_layout(h0.height, h0.width, h0.lanes)
    t_a = lay["t_a"]
    freqs = [np.asarray(s.freq, np.int64) for s in streams]
    scan = _Scan(streams)
    step_a = lay["step_ctx"][:t_a].astype(np.int64)
    vals_a = scan.run(np.stack([kernel_rows(step_a, f) for f in freqs], axis=1))
    rows_b = []
    for i, s in enumerate(streams):
        _qf, q_sorted = _nnz_map_from_padded(torch.from_numpy(vals_a[i]), s.header.decode_params, lay)
        rows_b.append(kernel_rows(ac_step_ctx(lay, q_sorted).numpy(), freqs[i]))
    vals_b = scan.run(np.stack(rows_b, axis=1))
    padded = np.concatenate([vals_a, vals_b], axis=1)
    return np.concatenate([padded[:, dst : dst + n_real] for _c, dst, n_real, _p in lay["spans"]], axis=1)
