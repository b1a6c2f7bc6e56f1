"""Image file I/O (port of `jxl_tpu/core/io.py`).

PNG and PNM are read and written with the standard library (zlib) and
numpy, so the port runs where no image library is installed:

- `read_png_rgb8`: 8-bit colour types 0 (grey), 2 (RGB), 3 (palette), 4
  (grey + alpha) and 6 (RGBA), non-interlaced, all five row filters; the
  result is RGB u8 as PIL's `convert("RGB")` gives it (grey replicated,
  alpha dropped).
- `write_png_rgb8`: 8-bit RGB, filter 0 on every row.

Other formats (JPEG, BMP, ...) and PNG variants outside that list (1/2/4
or 16-bit samples, interlacing) go through PIL when it imports; without it they
raise ValueError naming the missing library. `.jxt` files are decoded by
the port's codec on an explicit device; their metadata comes from the
container header alone.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from jxl_tpu_torch.core.image import ColorType, ImageFileData, ImageFormat, format_from_path

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pil():
    """PIL's Image module, or ValueError when it is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError("this image format needs PIL (Pillow), which is not installed") from e
    return Image


def _png_chunks(data: bytes, path: str):
    """(IHDR fields, PLTE bytes or None, concatenated IDAT bytes)."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG")
    o, idat, hdr, plte = 8, [], None, None
    while o + 8 <= len(data):
        (n,) = struct.unpack(">I", data[o : o + 4])
        kind, body = data[o + 4 : o + 8], data[o + 8 : o + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        o += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    return hdr, plte, b"".join(idat)


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of raw [H, stride] u8 (filter bytes
    stripped) with `bpp` bytes per filter unit. Each byte depends on its
    left, upper and upper-left neighbours of the same channel, so the
    pass walks anti-diagonals of filter units: every row with every
    filter type at once, H + W steps in all."""
    h, stride = raw.shape
    xs = stride // bpp
    line = raw.reshape(h, xs, bpp).astype(np.int32)
    out = np.zeros((h + 1, xs + 1, bpp), np.int32)  # one zero row above, one zero column left
    f_all = filters.astype(np.int32)
    for k in range(h + xs - 1):
        y = np.arange(max(0, k - xs + 1), min(h - 1, k) + 1)
        x = k - y
        a = out[y + 1, x]  # left
        b = out[y, x + 1]  # up
        c = out[y, x]  # up-left
        f = f_all[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (line[y, x] + pred) & 255
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def _png_supported(depth: int, ctype: int, interlace: int) -> bool:
    return depth == 8 and interlace == 0 and ctype in _PNG_CHANNELS


def read_png_rgb8(path: str) -> np.ndarray:
    """A non-interlaced PNG of 8-bit samples -> RGB u8 [H, W, 3], with the
    standard library's zlib and numpy. Raises ValueError on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    (w, h, depth, ctype, _comp, _filt, interlace), plte, idat = _png_chunks(data, path)
    if not _png_supported(depth, ctype, interlace):
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {ctype}, interlace {interlace} is not read here")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < h * (1 + w * ch):
        raise ValueError(f"{path}: truncated image data")
    raw = raw[: h * (1 + w * ch)].reshape(h, 1 + w * ch)
    if int(raw[:, 0].max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown PNG row filter")
    px = _unfilter(raw[:, 1:], raw[:, 0], ch).reshape(h, w, ch)
    if ctype in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    if ctype in (2, 6):
        return np.ascontiguousarray(px[:, :, :3])
    if plte is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    pal = np.zeros((256, 3), np.uint8)
    p = np.frombuffer(plte, np.uint8)[: len(plte) // 3 * 3].reshape(-1, 3)
    pal[: len(p)] = p
    return pal[px[:, :, 0]]


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png_rgb8(path: str, rgb: np.ndarray) -> None:
    """RGB u8 [H, W, 3] -> an 8-bit RGB PNG, filter 0 on every row."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    parts = []
    idx = 0
    # parse header tokens, skipping comments
    while len(parts) < 4:
        nl = data.find(b"\n", idx)
        line = data[idx : nl if nl != -1 else len(data)]
        idx = nl + 1
        line = line.split(b"#")[0]
        parts.extend(line.split())
    magic, w, h = parts[0], int(parts[1]), int(parts[2])
    raw = np.frombuffer(data[idx:], dtype=np.uint8)
    if magic == b"P6":
        return raw[: w * h * 3].reshape(h, w, 3)
    if magic == b"P5":
        g = raw[: w * h].reshape(h, w)
        return np.stack([g, g, g], axis=-1)
    raise ValueError(f"unsupported PNM magic {magic!r}")


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())


def _png_header(path: str):
    """A PNG's IHDR fields (width, height, depth, colour type, compression,
    filter, interlace), or None when the file does not start like a PNG."""
    with open(path, "rb") as f:
        head = f.read(29)
    if head[:8] != _PNG_MAGIC or head[12:16] != b"IHDR":
        return None
    return struct.unpack(">IIBBBBB", head[16:29])


def read_image(path: str, *, device=None) -> np.ndarray:
    """Read an image file to RGB uint8 [H, W, 3]. A `.jxt` file is decoded
    by the port on `device` (required for it); other formats are read on
    the host."""
    fmt = format_from_path(path)
    if fmt == ImageFormat.Jxt:
        if device is None:
            raise ValueError("decoding a .jxt file needs an explicit device")
        from jxl_tpu_torch.codec.decode import decode_file

        return decode_file(path, device=device)
    if fmt == ImageFormat.Pnm:
        return _read_ppm(path)
    if fmt == ImageFormat.Png:
        hdr = _png_header(path)
        if hdr is None or _png_supported(hdr[2], hdr[3], hdr[6]):
            return read_png_rgb8(path)
    return np.asarray(_pil().open(path).convert("RGB"), dtype=np.uint8)


def write_image(path: str, rgb: np.ndarray) -> None:
    """Write RGB uint8 [H, W, 3] to a file (format from extension)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    fmt = format_from_path(path)
    if fmt == ImageFormat.Pnm:
        _write_ppm(path, rgb)
    elif fmt == ImageFormat.Png:
        write_png_rgb8(path, rgb)
    else:
        _pil().fromarray(rgb, mode="RGB").save(path)


def read_image_metadata(path: str, test_set: str = "", commit: str = "") -> ImageFileData:
    """Build the 13-column metadata record for a file.

    For `.jxt` files, distance/effort/original-name come from the container
    header; for a PNG, width and height from its IHDR chunk; other formats
    are read whole."""
    fmt = format_from_path(path)
    file_size = os.path.getsize(path)
    name = os.path.basename(path)
    if fmt == ImageFormat.Jxt:
        from jxl_tpu_torch.codec.container import read_header

        hdr = read_header(path)
        return ImageFileData(
            image_name=name,
            commit=commit or hdr.strategy_name,
            test_set=test_set,
            file_path=path,
            width=hdr.width,
            height=hdr.height,
            file_size=file_size,
            raw_size=hdr.width * hdr.height * 3,
            color_space=ColorType.Rgb8,
            format=fmt,
            jxl_orig_image_name=hdr.orig_name,
            jxl_distance=hdr.distance,
            jxl_effort=hdr.effort,
        )
    hdr = _png_header(path) if fmt == ImageFormat.Png else None
    if hdr is not None:
        w, h = hdr[0], hdr[1]
    else:
        h, w = read_image(path).shape[:2]
    return ImageFileData(
        image_name=name,
        commit=commit,
        test_set=test_set,
        file_path=path,
        width=w,
        height=h,
        file_size=file_size,
        raw_size=w * h * 3,
        color_space=ColorType.Rgb8,
        format=fmt,
    )
