"""ctypes binding of the native host core (`native/jxt_native.cpp`).

The core is the repository's third, independent implementation of the
interleaved rANS scheme (32-bit states, 16-bit words in consumption order,
12-bit frequencies) and of the MSB-first bit packer: plain C++ loops, one
symbol at a time. The tests and `chip_smoke.py` hold the port's coder and
packers to it.

The source is compiled on first use with one g++ call (the flags of
`native/build.sh`) into the repository's `build/native/` directory; the
library name carries a hash of the source and the flags, so an edited
source is rebuilt. Nothing is built when the module is imported, and
nothing is written into `native/`. A failed build raises with the
compiler's output; there is no stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "jxt_native.cpp"
BUILD_DIR = REPO / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def available() -> bool:
    """Whether the core can be built here (g++ on PATH)."""
    return shutil.which("g++") is not None


def build() -> Path:
    """Compile the core (if not already built) and return the library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libjxt_native-{digest}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: cannot build {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


@lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """The built core, loaded once per process, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.rans_encode.restype = ctypes.c_int
    lib.rans_encode.argtypes = [i32p, i32p, i64, u32p, u32p, i32, i32, i64, u16p, i64p, u32p]
    lib.rans_decode.restype = ctypes.c_int
    lib.rans_decode.argtypes = [u16p, i64, u32p, i64, i32p, u32p, u32p, i32, i32, i32p]
    lib.pack_bits.restype = None
    lib.pack_bits.argtypes = [i32p, u32p, i64, u32p, i64]
    lib.unpack_bits.restype = None
    lib.unpack_bits.argtypes = [i32p, u32p, i64, u32p]
    return lib


def _host(a, dtype) -> np.ndarray:
    """A numpy array or CPU tensor as a contiguous numpy array of `dtype`
    (values cast as numpy casts them)."""
    return np.ascontiguousarray(np.asarray(a).astype(dtype, copy=False))


def _tables(freq, cum, n_ctx_used: int, alphabet_used: int):
    freq, cum = _host(freq, np.uint32), _host(cum, np.uint32)
    if freq.ndim != 2 or freq.shape != cum.shape:
        raise ValueError(f"freq / cum must be [C, A] tables of one shape, got {freq.shape} and {cum.shape}")
    if n_ctx_used > freq.shape[0] or alphabet_used > freq.shape[1]:
        raise ValueError(f"a context or token lies outside the [{freq.shape[0]}, {freq.shape[1]}] tables")
    return freq, cum


def _max_plus_one(a: np.ndarray) -> int:
    if a.size and int(a.min()) < 0:
        raise ValueError("negative token or context id")
    return int(a.max()) + 1 if a.size else 0


def rans_encode_native(tokens, ctx, freq, cum, lanes: int):
    """Host rANS encode; returns (words_flat [T * lanes] u16, n_words,
    states [lanes] u32) in the layout of `entropy.rans.rans_encode`."""
    tokens, ctx = _host(tokens, np.int32), _host(ctx, np.int32)
    n = tokens.shape[0]
    if ctx.shape != (n,) or lanes < 1:
        raise ValueError(f"tokens {tokens.shape} and ctx {ctx.shape} must be [n]; lanes {lanes} must be >= 1")
    freq, cum = _tables(freq, cum, _max_plus_one(ctx), _max_plus_one(tokens))
    if n and not freq[ctx, tokens].all():
        raise ValueError("a token has frequency 0 in its context")
    cap = max(1, -(-n // lanes)) * lanes
    words = np.zeros(cap, np.uint16)
    n_words = np.zeros(1, np.int64)
    states = np.zeros(lanes, np.uint32)
    rc = _load().rans_encode(
        tokens, ctx, n, freq.reshape(-1), cum.reshape(-1), freq.shape[1], lanes, cap, words, n_words, states
    )
    if rc != 0:
        raise RuntimeError(f"native rans_encode failed (rc {rc})")
    return words, int(n_words[0]), states


def rans_decode_native(words_flat, n_words, states, ctx, freq, cum, n: int, lanes: int):
    """Host rANS decode of n tokens from the first n_words consumption-order
    words; raises if the stream ends early or is not consumed exactly."""
    words_flat, states, ctx = _host(words_flat, np.uint16), _host(states, np.uint32), _host(ctx, np.int32)
    if not 0 <= int(n_words) <= words_flat.shape[0] or states.shape != (lanes,) or ctx.shape[0] < n:
        raise ValueError(
            f"n_words {int(n_words)} of {words_flat.shape[0]} words, states {states.shape} for {lanes} lanes, "
            f"{ctx.shape[0]} contexts for {n} tokens"
        )
    freq, cum = _tables(freq, cum, _max_plus_one(ctx[:n]), 0)
    out = np.zeros(n, np.int32)
    rc = _load().rans_decode(
        words_flat, int(n_words), states, n, ctx, freq.reshape(-1), cum.reshape(-1), freq.shape[1], lanes, out
    )
    if rc != 0:
        raise RuntimeError(f"native rans_decode failed (rc {rc}: -1 stream ended early, -2 words left over)")
    return out


def _bit_layout(nbits, mantissa_len: int | None, n_words: int) -> np.ndarray:
    nbits = _host(nbits, np.int32)
    if nbits.ndim != 1 or (mantissa_len is not None and mantissa_len != nbits.shape[0]):
        raise ValueError("nbits and mantissa must be [n] arrays of one length")
    if nbits.size and (int(nbits.min()) < 0 or int(nbits.max()) > 32):
        raise ValueError("nbits must lie in [0, 32]")
    if int(nbits.astype(np.int64).sum()) > 32 * n_words:
        raise ValueError(f"{int(nbits.astype(np.int64).sum())} bits do not fit in {n_words} words")
    return nbits


def pack_bits_native(nbits, mantissa, n_words: int) -> np.ndarray:
    """MSB-first bit packing into n_words u32 words (as `entropy.tokens.pack_bits`)."""
    mantissa = _host(mantissa, np.uint32)
    nbits = _bit_layout(nbits, mantissa.shape[0], n_words)
    out = np.zeros(n_words, np.uint32)
    _load().pack_bits(nbits, mantissa, nbits.shape[0], out, n_words)
    return out


def unpack_bits_native(nbits, words) -> np.ndarray:
    """Inverse of pack_bits_native: u32 mantissas."""
    words = _host(words, np.uint32)
    nbits = _bit_layout(nbits, None, words.shape[0])
    out = np.zeros(nbits.shape[0], np.uint32)
    _load().unpack_bits(nbits, words, nbits.shape[0], out)
    return out
