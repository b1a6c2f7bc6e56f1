"""JXT bitstream container (host-side serialization layer).

Port of `jxl_tpu/codec/container.py` (numpy only): the same v8 format,
byte for byte. Header geometry is validated in closed form
(`layout.layout_counts`), so a forged header never makes the reader build
layout tables.

The on-disk format of this framework's codec. Carries everything the decoder
needs; coding parameters (distance/effort/strategy, original image name) are
stored in the header — unlike the reference, which re-derives them by parsing
the output filename (`image_reader.rs:385-411`).

Layout (all little-endian):
  magic   b"JXT1"
  u8      version (=2)
  u32     height, width        (true, unpadded)
  f32     distance
  u8      effort
  u8      strategy             (Strategy enum value)
  u8      flags                (bit0: EPF enabled; bit1: lossless modular mode)
  u16     orig_name_len; bytes orig_name (utf-8)
  u16     lanes (K)
  u32     n_tokens
  u16     n_ctx (v8+: up to 765 position x bucket contexts)
  u8      alphabet (A)
  u8      n_clusters (v6+); u8[n_ctx] cluster map
  per-CLUSTER frequency tables (raw u16 row or sparse, see _pack_freq_tables)
  u32[K]  per-lane final rANS states
  u32     n_stream_words; u16[n_stream_words] rANS words (ragged lanes concat)
  u32     n_mant_bytes; u8[n_mant_bytes] mantissa bytes (LE per value)
  u32     n_acs_extra; ...     (reserved)
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

from jxl_tpu_torch.codec.layout import layout_counts
from jxl_tpu_torch.entropy.tokens import ALPHABET

MAGIC = b"JXT1"
# v4: consumption-order rANS stream (no per-lane lens)
# v5: grouped streams — per-128-lane-group word/mantissa segments with
#     per-group counts; z-major AC token order; K-padded context runs
# v6: clustered context models — u8 n_clusters + u8[n_ctx] cluster map,
#     then n_clusters deduplicated freq tables (entropy/cluster.py); the
#     decoder expands freq[c] = tables[map[c]]. v5 still readable.
# v7: RD coding upgrades — flags bits 2-3 signal the adaptive DC
#     predictor mode (0 none / 1 west / 2 gradient); the ACS and QF maps
#     are coded as causal L-column residuals (encode.predict_lcol); AC
#     reconstruction applies the centroid bias (quant.ac_recon_bias).
#
# v8: nnz-conditioned AC contexts — a per-(channel, block) nonzero-count
#     bucket map section (decoded before the ACs) conditions the AC
#     histograms (contexts = channel x zigzag position x bucket,
#     layout.py); the AC block axis is bucket-sorted per channel; flags
#     bit 6 (mode-field bit 4) signals causal nnz-map prediction. n_ctx
#     grew past 255, so the header field widened to u16.
#
# Only the CURRENT version is readable: the quant-step model
# (transforms/quant.py) is recomputed from constants that are retuned
# between versions and not signaled in the stream, so decoding an older
# version with current tables would silently dequantize with wrong steps
# (ADVICE r3). Older-version containers fail fast with a clear error.
VERSION = 8


def _pack_freq_tables(freq: np.ndarray) -> bytes:
    """Per-context frequency tables, sparse when that is smaller.

    Real images leave most contexts nearly degenerate (a flat image's
    tables are ~2 nonzero symbols each), so raw [A] u16 rows (74 B/ctx for
    A=37) waste header bytes that dominate small streams. Per context:
    u8 mode (0 = raw u16 row, 1 = sparse), sparse = u8 count + count x
    (u8 symbol, u16 freq).
    """
    out = []
    for row in freq:
        nz = np.nonzero(row)[0]
        sparse_size = 1 + 3 * len(nz)
        raw_size = 2 * len(row)
        if sparse_size < raw_size:
            parts = [struct.pack("<BB", 1, len(nz))]
            for s in nz:
                parts.append(struct.pack("<BH", int(s), int(row[s])))
            out.append(b"".join(parts))
        else:
            out.append(struct.pack("<B", 0) + row.astype("<u2").tobytes())
    return b"".join(out)


def _unpack_freq_tables(data: bytes, off: int, n_ctx: int, alphabet: int):
    freq = np.zeros((n_ctx, alphabet), np.uint32)
    for c in range(n_ctx):
        if off >= len(data):
            raise ValueError("malformed JXT container: truncated in frequency tables")
        mode = data[off]
        off += 1
        if mode == 0:
            if off + alphabet * 2 > len(data):
                raise ValueError("malformed JXT container: truncated in frequency tables")
            freq[c] = np.frombuffer(data, dtype="<u2", count=alphabet, offset=off)
            off += alphabet * 2
        elif mode == 1:
            if off >= len(data):
                raise ValueError("malformed JXT container: truncated in frequency tables")
            n = data[off]
            off += 1
            if off + 3 * n > len(data):
                raise ValueError("malformed JXT container: truncated in frequency tables")
            for _ in range(n):
                s, f = struct.unpack_from("<BH", data, off)
                off += 3
                if s >= alphabet:
                    raise ValueError(
                        f"malformed JXT container: frequency table symbol {s} "
                        f"outside alphabet {alphabet}"
                    )
                freq[c, s] = f
        else:
            raise ValueError(f"malformed JXT container: frequency table mode {mode} unknown")
    return freq, off


@dataclass
class JxtHeader:
    height: int
    width: int
    distance: float
    effort: int
    strategy: int
    orig_name: str
    lanes: int
    n_tokens: int
    n_ctx: int
    alphabet: int
    flags: int = 1  # bit0: EPF enabled
    version: int = VERSION

    @property
    def epf(self) -> bool:
        return bool(self.flags & 1)

    @property
    def lossless(self) -> bool:
        """Flag bit 1: d=0 modular mode (codec/lossless.py)."""
        return bool(self.flags & 2)

    @property
    def mode_field(self) -> int:
        """v7 coding-mode field (flags bits 2-7). Lossy: bits 0-1 dc
        predictor, bit 2 acs-map pred, bit 3 qf-map pred. Lossless:
        3 x 2-bit per-channel predictor modes."""
        return (self.flags >> 2) & 0x3F

    @property
    def dc_mode(self) -> int:
        """DC predictor mode; pre-v7 streams always used gradient."""
        return (self.mode_field & 3) if self.version >= 7 else 2

    @property
    def decode_params(self) -> int:
        """Traced coding-params word for the decoder.

        Lossy: bits 0-1 dc_mode, bit 2 AC reconstruction bias, bit 3
        ACS-map causal prediction, bit 4 QF-map causal prediction, bit 5
        nnz-map causal prediction (v8), bit 6 EPF enabled (TRACED so one
        compiled decoder serves both per-image adaptive-EPF outcomes and
        RD-grid rows can mix them). Lossless: the raw per-channel
        predictor-mode field."""
        if self.lossless:
            return self.mode_field
        m = self.mode_field
        return (
            (m & 3)
            | 0b100
            | (((m >> 2) & 1) << 3)
            | (((m >> 3) & 1) << 4)
            | (((m >> 4) & 1) << 5)
            | ((1 if self.epf else 0) << 6)
        )

    @property
    def strategy_name(self) -> str:
        from jxl_tpu_torch.codec.config import Strategy

        return Strategy(self.strategy).name


@dataclass
class JxtStream:
    header: JxtHeader
    freq: np.ndarray  # [n_ctx, A] uint32 (cluster-expanded)
    states: np.ndarray  # [K] uint32
    stream_words: bytes  # per-group consumption-order word segments, u16 LE
    mant_bytes: bytes  # per-group mantissa byte segments (LE within a value)
    wcounts: np.ndarray = None  # [G] uint32 words per group
    mcounts: np.ndarray = None  # [G] uint32 mantissa bytes per group
    acs_extra: bytes = b""
    # clustered form (read_container fills these)
    tables: np.ndarray = None  # [n_clusters, A] uint32
    cmap: np.ndarray = None  # [n_ctx] uint8


def write_container(s: JxtStream) -> bytes:
    h = s.header
    name_b = h.orig_name.encode("utf-8")
    out = [
        MAGIC,
        struct.pack(
            "<BIIfBBBH",
            VERSION,
            h.height,
            h.width,
            h.distance,
            h.effort,
            h.strategy,
            h.flags,
            len(name_b),
        ),
        name_b,
        struct.pack("<HIHB", h.lanes, h.n_tokens, h.n_ctx, h.alphabet),
    ]
    # Clustered tables (v6): identical rows (produced by the encoder's
    # on-device histogram clustering) are signaled once, in first-
    # occurrence order (a dict dedupe — np.unique(axis=0)'s structured
    # argsort cost 5.6 ms per container at v8's 765 rows). v8's map is
    # 765 entries with long runs of equal ids (positions of a channel x
    # bucket stripe mostly share a cluster), so it is RLE-coded when that
    # is smaller: mode byte 0 = raw u8[n_ctx], 1 = u16 n_pairs +
    # (u8 id, u8 runlen) pairs (runlen 1..255, long runs split).
    freq_rows = np.ascontiguousarray(np.asarray(s.freq).astype(np.uint16))
    seen: dict = {}
    cmap = np.empty(len(freq_rows), np.uint8)
    table_rows = []
    for i in range(len(freq_rows)):
        key = freq_rows[i].tobytes()
        j = seen.get(key)
        if j is None:
            j = len(table_rows)
            seen[key] = j
            table_rows.append(freq_rows[i])
        cmap[i] = j
    tables = np.stack(table_rows).astype(np.uint32)
    pairs = []
    i = 0
    while i < len(cmap):
        j = i
        while j < len(cmap) and cmap[j] == cmap[i] and j - i < 255:
            j += 1
        pairs.append((int(cmap[i]), j - i))
        i = j
    rle = struct.pack("<H", len(pairs)) + b"".join(
        struct.pack("<BB", cid, rl) for cid, rl in pairs
    )
    if len(rle) + 1 < len(cmap) + 1:
        cmap_b = struct.pack("<B", 1) + rle
    else:
        cmap_b = struct.pack("<B", 0) + cmap.tobytes()
    out += [
        struct.pack("<B", len(tables)),
        cmap_b,
        _pack_freq_tables(tables),
    ]
    out += [
        s.states.astype("<u4").tobytes(),
        np.asarray(s.wcounts, dtype="<u4").tobytes(),
        np.asarray(s.mcounts, dtype="<u4").tobytes(),
        struct.pack("<I", len(s.stream_words) // 2),
        s.stream_words,
        struct.pack("<I", len(s.mant_bytes)),
        s.mant_bytes,
        struct.pack("<I", len(s.acs_extra)),
        s.acs_extra,
    ]
    return b"".join(out)


# Decoder hardening bounds (VERDICT r4 item 5): every count/length field a
# malformed container could forge is checked against these and against the
# remaining buffer BEFORE any allocation or device work. A single JXT
# section is capped at 64 MP = 8192x8192 (the layout tables alone cost
# ~12 B/pixel of host memory to build, and gigapixel inputs ride the
# striped JXTS format whose stripes are ~8 MP); lanes are bounded so the
# rANS kernels' per-group blocks stay few.
MAX_DIM = 1 << 20
MAX_PIXELS = 1 << 26
MAX_LANES = 8192


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"malformed JXT container: {msg}")


def read_container(data: bytes) -> JxtStream:
    """Parse a JXT container. Raises ValueError (never hangs, never makes
    an allocation unbounded by the input size) on malformed input: every
    length/count field is validated against the remaining buffer, the
    image-geometry caps above, and internal consistency (section sums).
    The reference inherits libjxl's hardened decoder and its harness's
    skip-on-failure contract assumes codec failures are clean errors
    (`benchmark.rs:661-677`)."""
    _check(data[:4] == MAGIC, "bad magic (not a JXT stream)")
    try:
        return _read_container_checked(data)
    except (struct.error, IndexError) as e:
        raise ValueError(f"malformed JXT container: truncated ({e})") from e


def _read_container_checked(data: bytes) -> JxtStream:
    off = 4
    version, height, width, distance, effort, strategy, flags, name_len = struct.unpack_from(
        "<BIIfBBBH", data, off
    )
    if version != VERSION:
        raise ValueError(
            f"JXT container version {version} is not decodable by this build "
            f"(expected {VERSION}): quant-step constants are per-version and "
            "not signaled in the stream"
        )
    _check(0 < height <= MAX_DIM and 0 < width <= MAX_DIM, "bad image dims")
    _check(
        math.isfinite(distance) and 0.0 <= distance <= 1e4,
        "distance out of range",
    )
    _check(height * width <= MAX_PIXELS, "image exceeds single-section cap")
    off += struct.calcsize("<BIIfBBBH")
    _check(off + name_len <= len(data), "name overruns buffer")
    orig_name = data[off : off + name_len].decode("utf-8", errors="replace")
    off += name_len
    lanes, n_tokens, n_ctx, alphabet = struct.unpack_from("<HIHB", data, off)
    off += struct.calcsize("<HIHB")
    _check(
        128 <= lanes <= MAX_LANES and lanes % 128 == 0,
        "lanes not a multiple of the 128-lane group",
    )
    # n_tokens/n_ctx must match what the decoder derives from the geometry;
    # anything else would silently mis-slice the decoded stream. Closed
    # form: untrusted dimensions never drive a layout build.
    modular = bool(flags & 2)
    want_tokens, want_ctx = layout_counts(height, width, modular)
    _check(n_tokens == want_tokens, "n_tokens inconsistent with geometry")
    _check(n_ctx == want_ctx, "n_ctx inconsistent with coding mode")
    _check(alphabet == ALPHABET, "alphabet mismatch")
    _check(off + 2 <= len(data), "truncated before cluster header")
    n_clusters = data[off]
    off += 1
    _check(1 <= n_clusters <= min(n_ctx, 255), "bad cluster count")
    cmap_mode = data[off]
    off += 1
    if cmap_mode == 1:  # RLE (see write_container)
        (n_pairs,) = struct.unpack_from("<H", data, off)
        off += 2
        _check(off + 2 * n_pairs <= len(data), "cluster RLE overruns buffer")
        cmap = np.empty(n_ctx, np.uint8)
        pos = 0
        for _ in range(n_pairs):
            cid, rl = data[off], data[off + 1]
            off += 2
            _check(pos + rl <= n_ctx, "cluster RLE overruns context map")
            cmap[pos : pos + rl] = cid
            pos += rl
        _check(pos == n_ctx, "cluster RLE does not cover the context map")
    elif cmap_mode == 0:
        _check(off + n_ctx <= len(data), "cluster map overruns buffer")
        cmap = np.frombuffer(data, dtype="<u1", count=n_ctx, offset=off)
        off += n_ctx
    else:
        raise ValueError("malformed JXT container: unknown cluster-map mode")
    _check(int(cmap.max()) < n_clusters, "cluster id outside table range")
    tables, off = _unpack_freq_tables(data, off, n_clusters, alphabet)
    freq = tables[cmap]
    tables_out, cmap_out = tables, np.asarray(cmap, np.uint8)
    _check(off + lanes * 4 <= len(data), "states overrun buffer")
    states = np.frombuffer(data, dtype="<u4", count=lanes, offset=off).astype(np.uint32)
    off += lanes * 4
    n_groups = lanes // 128
    _check(off + 8 * n_groups <= len(data), "group counts overrun buffer")
    wcounts = np.frombuffer(data, dtype="<u4", count=n_groups, offset=off).astype(np.uint32)
    off += n_groups * 4
    mcounts = np.frombuffer(data, dtype="<u4", count=n_groups, offset=off).astype(np.uint32)
    off += n_groups * 4
    (n_stream_words,) = struct.unpack_from("<I", data, off)
    off += 4
    _check(off + n_stream_words * 2 <= len(data), "word stream overruns buffer")
    _check(
        int(wcounts.sum()) == n_stream_words,
        "per-group word counts do not sum to the stream length",
    )
    stream_words = data[off : off + n_stream_words * 2]
    off += n_stream_words * 2
    (n_mant_bytes,) = struct.unpack_from("<I", data, off)
    off += 4
    _check(off + n_mant_bytes <= len(data), "mantissa stream overruns buffer")
    _check(
        int(mcounts.sum()) == n_mant_bytes,
        "per-group mantissa counts do not sum to the stream length",
    )
    mant_bytes = data[off : off + n_mant_bytes]
    off += n_mant_bytes
    (n_acs,) = struct.unpack_from("<I", data, off)
    off += 4
    _check(off + n_acs <= len(data), "extra section overruns buffer")
    acs_extra = data[off : off + n_acs]
    if modular and n_acs:
        # lossless extra section == the palette (codec/encode._palette_of)
        _check(
            n_acs % 3 == 0 and n_acs // 3 <= 256,
            "palette section is not <= 256 RGB triples",
        )
    header = JxtHeader(
        height=height,
        width=width,
        distance=distance,
        effort=effort,
        strategy=strategy,
        orig_name=orig_name,
        lanes=lanes,
        n_tokens=n_tokens,
        n_ctx=n_ctx,
        alphabet=alphabet,
        flags=flags,
        version=version,
    )
    return JxtStream(
        header=header,
        freq=freq,
        states=states,
        stream_words=stream_words,
        mant_bytes=mant_bytes,
        wcounts=wcounts,
        mcounts=mcounts,
        acs_extra=acs_extra,
        tables=tables_out,
        cmap=cmap_out,
    )


def read_header(path: str) -> JxtHeader:
    """The header of the .jxt file at `path` (its first 64 KiB are read)."""
    with open(path, "rb") as f:
        data = f.read(64 * 1024)
    return read_container_header(data)


def read_container_header(data: bytes) -> JxtHeader:
    _check(data[:4] == MAGIC, "bad magic (not a JXT stream)")
    off = 4
    try:
        version, height, width, distance, effort, strategy, flags, name_len = struct.unpack_from(
            "<BIIfBBBH", data, off
        )
        off += struct.calcsize("<BIIfBBBH")
        _check(off + name_len <= len(data), "name overruns buffer")
        orig_name = data[off : off + name_len].decode("utf-8", errors="replace")
        off += name_len
        lanes, n_tokens, n_ctx, alphabet = struct.unpack_from("<HIHB", data, off)
    except struct.error as e:
        raise ValueError(f"malformed JXT container: truncated ({e})") from e
    return JxtHeader(
        height=height,
        width=width,
        distance=distance,
        effort=effort,
        strategy=strategy,
        orig_name=orig_name,
        lanes=lanes,
        n_tokens=n_tokens,
        n_ctx=n_ctx,
        alphabet=alphabet,
        flags=flags,
        version=version,
    )
