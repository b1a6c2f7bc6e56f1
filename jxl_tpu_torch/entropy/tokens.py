"""Hybrid-uint tokenization (port of `jxl_tpu/entropy/tokens.py`).

- token(v) = v for v < 32, else 27 + floor(log2 v), with
  nbits = token - 27 mantissa bits (v = 2^nbits + mantissa).
- signed values map to unsigned by the zigzag map 2v / -2v-1 first.
- mantissas are stored byte-aligned, ceil(nbits/8) <= MAX_NBYTES bytes.

Values are int32 tensors (the reference's uint32 values stay below 2^25).
The mantissa packers (`pack_bytes` / `unpack_bytes`, and the bit-exact
MSB-first `pack_bits` / `unpack_bits` that the native core is held to)
and `detokenize` return the reference's uint32 arrays as int64 tensors in
[0, 2^32), on their inputs' device. Where the reference's scatters drop an
index past the buffer, they write to one extra slot that is cut off; where
its gathers clamp an index, so do these.
"""

from __future__ import annotations

import torch

TOKEN_SPLIT = 32  # values below this are their own token
MAX_NBITS = 24  # supports values up to 2^25 - 1
MAX_NBYTES = 3
ALPHABET = TOKEN_SPLIT + (MAX_NBITS - 5) + 1  # tokens 0..51 -> 52 symbols
_U32 = 0xFFFFFFFF


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


def detokenize(token: torch.Tensor, mantissa: torch.Tensor) -> torch.Tensor:
    """(token, mantissa) -> values, int64 in [0, 2^32)."""
    token = token.to(torch.int64)
    big = token >= TOKEN_SPLIT
    exp = torch.where(big, token - 27, 0)
    return torch.where(big, ((1 << exp) + mantissa.to(torch.int64)) & _U32, token & _U32)


def nbits_to_nbytes(nbits: torch.Tensor) -> torch.Tensor:
    return (nbits.to(torch.int32) + 7) // 8


def pack_bytes(nbits: torch.Tensor, mantissa: torch.Tensor, cap_bytes: int):
    """Pack mantissas into a byte stream, little-endian within each one.
    Returns (bytes [cap_bytes] int64 values 0..255, total_bytes int64
    scalar tensor); bytes past cap_bytes are dropped."""
    nbytes = nbits_to_nbytes(nbits).to(torch.int64)
    offsets = torch.cumsum(nbytes, 0) - nbytes
    out = torch.zeros(cap_bytes + 1, dtype=torch.int64, device=nbits.device)
    m = mantissa.to(torch.int64) & _U32
    for j in range(MAX_NBYTES):
        idx = offsets + j
        out[torch.where((j < nbytes) & (idx < cap_bytes), idx, cap_bytes)] = (m >> (8 * j)) & 0xFF
    return out[:cap_bytes], nbytes.sum()


def unpack_bytes(nbits: torch.Tensor, bytes_arr: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_bytes: per-symbol mantissas, masked to the declared
    bit count (robustness against corrupt streams)."""
    nbytes = nbits_to_nbytes(nbits).to(torch.int64)
    offsets = torch.cumsum(nbytes, 0) - nbytes
    src = bytes_arr.to(torch.int64)
    out = torch.zeros(nbits.shape, dtype=torch.int64, device=nbits.device)
    for j in range(MAX_NBYTES):
        mask = j < nbytes
        byte = src[torch.where(mask, offsets + j, 0).clamp(0, src.shape[0] - 1)] & 0xFF
        out = out | torch.where(mask, byte << (8 * j), 0)
    return out & ((1 << nbits.to(torch.int64)) - 1)


def byte_capacity(n_symbols: int) -> int:
    """Static byte budget for n symbols' mantissas."""
    return max(4, n_symbols * MAX_NBYTES)


def pack_bits(nbits: torch.Tensor, mantissa: torch.Tensor, total_words: int):
    """MSB-first bit packing into 32-bit words, accumulated by addition
    (bits past total_words are dropped). Returns (words [total_words] int64
    in [0, 2^32), total_bits int64 scalar tensor)."""
    nbits = nbits.to(torch.int64)
    offsets = torch.cumsum(nbits, 0) - nbits
    m = mantissa.to(torch.int64) & _U32
    acc = torch.zeros(total_words + 1, dtype=torch.int64, device=nbits.device)
    for b in range(MAX_NBITS):
        mask = b < nbits
        bitpos = offsets + b
        word_idx = torch.where(mask & (bitpos // 32 < total_words), bitpos // 32, total_words)
        bit = (m >> (nbits - 1 - b).clamp(min=0)) & 1
        acc.index_add_(0, word_idx, torch.where(mask, bit << (31 - bitpos % 32), 0))
    return acc[:total_words] & _U32, nbits.sum()


def unpack_bits(nbits: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_bits (word reads past the end clamp to the last word)."""
    nbits = nbits.to(torch.int64)
    offsets = torch.cumsum(nbits, 0) - nbits
    src = words.to(torch.int64) & _U32
    out = torch.zeros(nbits.shape, dtype=torch.int64, device=nbits.device)
    for b in range(MAX_NBITS):
        mask = b < nbits
        bitpos = offsets + b
        w = src[torch.where(mask, bitpos // 32, 0).clamp(max=src.shape[0] - 1)]
        bit = (w >> (31 - bitpos % 32)) & 1
        out = out | torch.where(mask, bit << (nbits - 1 - b).clamp(min=0), 0)
    return out


def bit_capacity_words(n_symbols: int) -> int:
    """Static 32-bit word budget for n symbols' mantissas (bit packer)."""
    return max(1, (n_symbols * MAX_NBITS + 31) // 32)
