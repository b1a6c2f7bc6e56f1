"""The encoder's context histograms: CUDA kernel H1's wrapper and its plain
versions.

`histogram_stepped(tokp, step_ctx, lanes, n_ctx)` counts a padded token
stream whose context is constant within each step of `lanes` tokens into
`[n_ctx, A]` (the entropy stage's per-context tables); `ac_counts4(ac_tok,
qb)` counts the `[3, nb, 63]` AC tokens by (channel, position, nnz bucket)
into `[3, 63, NNZ_Q, A]` (the front end's nnz-conditioning statistic).
Both are exact int64 counts. A CUDA tensor runs kernel H1
(`csrc/hist.cu`: one zeroed output, one launch, no read-back); a CPU
tensor runs the plain version, `torch.bincount` over the flattened
(row, token) index; another device raises ValueError. H1 replaces no TPU
kernel: `jxl_tpu` computes the counts as one-hot reductions.
"""

from __future__ import annotations

import torch

from jxl_tpu_torch.codec.layout import NNZ_Q
from jxl_tpu_torch.cuda_build import check_tensor, launch, route
from jxl_tpu_torch.entropy.tokens import ALPHABET

AC_POS = 63  # AC positions of a block


def stepped_index(tokp: torch.Tensor, step_ctx: torch.Tensor, lanes: int) -> torch.Tensor:
    """The flat (context, token) index of each token of a padded stream."""
    return torch.repeat_interleave(step_ctx.to(torch.int64), lanes) * ALPHABET + tokp.to(torch.int64)


def ac_index(ac_tok: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """The flat (channel, position, bucket, token) index of each AC token."""
    dev = ac_tok.device
    c = torch.arange(3, device=dev)[:, None, None]
    p = torch.arange(AC_POS, device=dev)[None, None, :]
    idx = ((c * AC_POS + p) * NNZ_Q + qb.to(torch.int64)[:, :, None]) * ALPHABET + ac_tok.to(torch.int64)
    return idx.reshape(-1)


def histogram_stepped_plain(tokp: torch.Tensor, step_ctx: torch.Tensor, lanes: int, n_ctx: int) -> torch.Tensor:
    """Plain version of the stepped form (any device)."""
    return torch.bincount(stepped_index(tokp, step_ctx, lanes), minlength=n_ctx * ALPHABET).reshape(n_ctx, ALPHABET)


def ac_counts4_plain(ac_tok: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Plain version of the AC form (any device)."""
    counts = torch.bincount(ac_index(ac_tok, qb), minlength=3 * AC_POS * NNZ_Q * ALPHABET)
    return counts.reshape(3, AC_POS, NNZ_Q, ALPHABET)


def _launch(tok: torch.Tensor, key: torch.Tensor, group: int, n_rows: int, nb: int) -> torch.Tensor:
    """H1 over `tok` (int32, `key.numel()` groups of `group` tokens) under
    the int64 keys, into a zeroed int64 [n_rows, A] on their device, on the
    current stream (no read-back)."""
    out = torch.zeros((n_rows, ALPHABET), dtype=torch.int64, device=tok.device)
    if key.numel():
        launch("hist", tok.device, tok.data_ptr(), key.data_ptr(), key.numel(), group, n_rows, nb, out.data_ptr())
    return out


def histogram_stepped_cuda(tokp: torch.Tensor, step_ctx: torch.Tensor, lanes: int, n_ctx: int) -> torch.Tensor:
    """The stepped form through H1: tokp int32 [T * lanes] (16-byte
    aligned), step_ctx int64 [T], lanes a positive multiple of 4."""
    dev = tokp.device
    T = step_ctx.numel()
    check_tensor("step_ctx", step_ctx, torch.int64, (T,), dev)
    check_tensor("tokp", tokp, torch.int32, (T * lanes,), dev)
    if lanes <= 0 or lanes % 4 or n_ctx <= 0:
        raise ValueError(f"histogram_stepped: lanes {lanes} (a positive multiple of 4), n_ctx {n_ctx}")
    if tokp.data_ptr() % 16:
        raise ValueError("tokp is not 16-byte aligned")
    return _launch(tokp, step_ctx, lanes, n_ctx, 0)


def ac_counts4_cuda(ac_tok: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """The AC form through H1: ac_tok int32 [3, nb, 63], qb int64 [3, nb]."""
    dev = ac_tok.device
    nb = ac_tok.shape[1] if ac_tok.dim() == 3 else -1
    check_tensor("ac_tok", ac_tok, torch.int32, (3, nb, AC_POS), dev)
    check_tensor("qb", qb, torch.int64, (3, nb), dev)
    out = _launch(ac_tok, qb, AC_POS, 3 * AC_POS * NNZ_Q, nb)
    return out.reshape(3, AC_POS, NNZ_Q, ALPHABET)


def histogram_stepped(tokp: torch.Tensor, step_ctx: torch.Tensor, lanes: int, n_ctx: int) -> torch.Tensor:
    """Exact per-context histogram [n_ctx, A] of a padded stream whose
    context is constant within each step of `lanes` tokens: H1 on a CUDA
    tensor, the plain version on a CPU one."""
    run = route("histogram_stepped", tokp.device, histogram_stepped_cuda, histogram_stepped_plain)
    return run(tokp, step_ctx, lanes, n_ctx)


def ac_counts4(ac_tok: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """[3, 63, NNZ_Q, A] AC token counts by (channel, position, bucket): H1
    on a CUDA tensor, the plain version on a CPU one."""
    return route("ac_counts4", ac_tok.device, ac_counts4_cuda, ac_counts4_plain)(ac_tok, qb)
