"""Hybrid-uint tokenization (port of `jxl_tpu/entropy/tokens.py`).

- token(v) = v for v < 32, else 27 + floor(log2 v), with
  nbits = token - 27 mantissa bits (v = 2^nbits + mantissa).
- signed values map to unsigned by the zigzag map 2v / -2v-1 first.
- mantissas are stored byte-aligned, ceil(nbits/8) <= MAX_NBYTES bytes.

Values are int32 tensors (the reference's uint32 values stay below 2^25).
"""

from __future__ import annotations

import torch

TOKEN_SPLIT = 32  # values below this are their own token
MAX_NBITS = 24  # supports values up to 2^25 - 1
MAX_NBYTES = 3
ALPHABET = TOKEN_SPLIT + (MAX_NBITS - 5) + 1  # tokens 0..51 -> 52 symbols


def zigzag_map(v: torch.Tensor) -> torch.Tensor:
    """Signed -> unsigned: 0,-1,1,-2,2.. -> 0,1,2,3,4.. (int32)."""
    v = v.to(torch.int32)
    return torch.where(v >= 0, 2 * v, -2 * v - 1)


def zigzag_unmap(u: torch.Tensor) -> torch.Tensor:
    u = u.to(torch.int32)
    return torch.where(u % 2 == 0, u // 2, -(u // 2) - 1)


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of nonnegative integers below 2^53 (0 for 0), exact:
    frexp's exponent of the float64 value."""
    return torch.frexp(v.to(torch.float64)).exponent.to(torch.int32)


def tokenize(values: torch.Tensor):
    """Nonnegative int values -> (token int32, nbits int32, mantissa int32)."""
    v = values.to(torch.int64)
    big = v >= TOKEN_SPLIT
    exp = torch.where(big, bit_length(v) - 1, 0)
    token = torch.where(big, 27 + exp, v.to(torch.int32)).to(torch.int32)
    nbits = exp.to(torch.int32)
    mantissa = torch.where(big, v - (1 << exp.to(torch.int64)), 0).to(torch.int32)
    return token, nbits, mantissa


def token_nbits(token: torch.Tensor) -> torch.Tensor:
    """Mantissa bit count implied by a token (decoder side)."""
    token = token.to(torch.int32)
    return torch.where(token >= TOKEN_SPLIT, token - 27, 0)
