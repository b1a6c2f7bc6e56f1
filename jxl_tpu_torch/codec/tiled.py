"""Striped JXTS containers (port of `jxl_tpu/codec/tiled.py`).

A `JXTS` wrapper holds N independent `.jxt` sections, each a full-height
vertical stripe of the image (widths multiples of 8 px, the last taking the
remainder). Every section is a standard single-image container, so an image
above the single-section cap (`container.MAX_PIXELS`) is coded stripe by
stripe and the device holds one stripe's working set at a time.

- Encode: `encode_image_striped` runs the per-image encode on each stripe
  (`encode_images`), on one device; `encode_image_striped_sharded` spreads
  equal-width lossy stripes over a device mesh
  (`distributed.sharded.encode_batch_sharded`) and gives the same bytes.
- Decode: modular sections decode to RGB; each maximal run of VarDCT
  sections decodes to pre-EPF XYB planes (`decode.decode_stream_planes`),
  the planes are concatenated and ONE EPF pass runs over the run, so the
  seam columns are filtered with their true neighbours across the seam and
  not with replicated edges.

Sections are coded independently (DC prediction, CfL tiles and histogram
clustering start anew in each stripe); EPF is the only operator that
crosses a seam, and it does so exactly at stitch time.
"""

from __future__ import annotations

import struct
from dataclasses import replace

import numpy as np
import torch

from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.codec.container import MAX_DIM, MAX_PIXELS, _check, read_container, read_container_header
from jxl_tpu_torch.core.device import resolve_device
from jxl_tpu_torch.core.xyb import xyb_to_srgb
from jxl_tpu_torch.transforms.epf import epf_apply

STRIPED_MAGIC = b"JXTS"
STRIPED_VERSION = 1
_HEAD = "<4sBBHII"  # magic, version, flags, section count, height, width

# Default stripe sizing: bound the per-stripe working set to roughly this
# many megapixels.
DEFAULT_STRIPE_MP = 8.0


def stripe_widths(width: int, n_stripes: int) -> list[int]:
    """Split `width` into n stripes, each a multiple of 8 px (the block
    unit); the last stripe absorbs the remainder."""
    assert width >= 8 * n_stripes, f"width {width} too small for {n_stripes} stripes"
    base = (width // n_stripes) // 8 * 8
    widths = [base] * n_stripes
    widths[-1] = width - base * (n_stripes - 1)
    return widths


def default_n_stripes(height: int, width: int, stripe_mp: float = DEFAULT_STRIPE_MP) -> int:
    n = max(1, int(np.ceil(height * width / (stripe_mp * 1e6))))
    return min(n, max(1, width // 256))  # keep stripes >= 256 px wide


def write_striped(height: int, width: int, sections: list[bytes]) -> bytes:
    head = struct.pack(_HEAD, STRIPED_MAGIC, STRIPED_VERSION, 0, len(sections), height, width)
    lens = struct.pack(f"<{len(sections)}I", *(len(s) for s in sections))
    return head + lens + b"".join(sections)


def read_striped_header(data: bytes):
    """-> (height, width, section count) from the first 16 bytes of a
    wrapper, validated; ValueError on a malformed one."""
    _check(data[:4] == STRIPED_MAGIC, "bad magic (not a striped JXT stream)")
    try:
        _magic, version, _flags, n, height, width = struct.unpack_from(_HEAD, data, 0)
    except struct.error as e:
        raise ValueError(f"malformed striped container: truncated ({e})") from e
    _check(version == STRIPED_VERSION, f"unknown striped version {version}")
    _check(0 < height <= MAX_DIM and 0 < width <= MAX_DIM and n >= 1, "bad striped geometry")
    return height, width, n


def read_striped(data: bytes):
    """-> (height, width, [section bytes]). Raises ValueError on any
    malformed wrapper (the hardening contract of container.read_container):
    every declared length is validated against the remaining buffer before
    any section is parsed or allocated."""
    height, width, n = read_striped_header(data)
    try:
        off = struct.calcsize(_HEAD)
        _check(off + 4 * n <= len(data), "section table overruns buffer")
        lens = struct.unpack_from(f"<{n}I", data, off)
    except struct.error as e:
        raise ValueError(f"malformed striped container: truncated ({e})") from e
    off += 4 * n
    sections = []
    for L in lens:
        # a truncated or corrupt input fails at the wrapper parse, not as a
        # container error some sections later
        _check(off + L <= len(data), f"striped section needs bytes [{off}, {off + L}) of {len(data)}")
        sections.append(data[off : off + L])
        off += L
    _check(off == len(data), f"{len(data) - off} trailing bytes")
    return height, width, sections


def is_striped(data: bytes) -> bool:
    return data[:4] == STRIPED_MAGIC


def encode_image_striped(
    rgb: np.ndarray, config: CodecConfig, n_stripes: int | None = None, orig_name: str = "", *, device
) -> bytes:
    """Encode as N independent full-height stripes on `device`, which holds
    one stripe's working set at a time.

    The stripe count (default `default_n_stripes`) is raised until every
    section fits the decoder's single-section cap. The name rides on
    section 0. With more than one stripe the VarDCT-vs-modular decision is
    made per stripe when the whole image is a modular candidate (mixed
    content: a screenshot beside a photo), and switched off otherwise, so
    plain photographic stripes all code VarDCT.

    The reference sends equal-width lossy stripes through a depth-2
    pipeline of batched dispatches, which hides its upload time; the
    port's batch encode is byte-identical to `encode_images`, so one loop
    over `encode_images` gives the same sections for every stripe layout."""
    from jxl_tpu_torch.codec.encode import _modular_candidate, encode_images, encoder_knobs

    rgb = np.asarray(rgb)
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    if n_stripes is None:
        n_stripes = default_n_stripes(h, w)
    # never write a container whose sections the port's own decoder rejects
    n_stripes = max(n_stripes, -(-h * w // MAX_PIXELS))
    assert w >= 8 * n_stripes and h <= MAX_PIXELS // 8, (
        f"{h}x{w} cannot be striped into <= {MAX_PIXELS}-pixel sections"
    )
    edges = np.concatenate([[0], np.cumsum(stripe_widths(w, n_stripes))])
    stripes = [rgb[:, edges[i] : edges[i + 1]] for i in range(n_stripes)]
    names = [orig_name if i == 0 else "" for i in range(n_stripes)]
    per_stripe_modes = (
        config.modular
        and config.distance > 0
        and n_stripes > 1
        and _modular_candidate(rgb, encoder_knobs().modular)
    )
    if n_stripes > 1 and not per_stripe_modes:
        config = replace(config, modular=False)
    sections = encode_images([(s, config, nm) for s, nm in zip(stripes, names)], device=device)
    return write_striped(h, w, sections)


def encode_image_striped_sharded(
    rgb: np.ndarray, config: CodecConfig, mesh, n_stripes: int | None = None, orig_name: str = ""
) -> bytes:
    """Striped encode with the stripes as the data-parallel batch of
    `distributed.sharded.encode_batch_sharded`: stripe i runs on the device
    of mesh row i % data. Sections are byte-identical to the sequential
    `encode_image_striped` (equal-width stripes required: width must
    divide by 8 * n_stripes; default n_stripes: the mesh's data size)."""
    from jxl_tpu_torch.distributed.sharded import encode_batch_sharded

    rgb = np.asarray(rgb)
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    # encode_batch_sharded floors the distance at 0.05 and always codes
    # VarDCT: a d = 0 request must not silently come out lossy
    assert config.distance > 0.0, (
        "lossless (d=0) striped encode is sequential-only: use "
        "encode_image_striped (the sharded batch path has no modular mode)"
    )
    if n_stripes is None:
        n_stripes = int(mesh.shape["data"])
    assert w % (8 * n_stripes) == 0, (
        f"sharded striping needs equal block-aligned stripes: width {w} must divide by {8 * n_stripes}"
    )
    ws = w // n_stripes
    stripes = [rgb[:, i * ws : (i + 1) * ws] for i in range(n_stripes)]
    names = [orig_name] + [""] * (n_stripes - 1)
    return write_striped(h, w, encode_batch_sharded(stripes, config, mesh=mesh, orig_names=names))


def _stitch_finish(planes: torch.Tensor, eff_mul: torch.Tensor, distance: float, *, height: int, width: int, epf: bool):
    """Stitched pre-EPF planes -> RGB u8 [height, width, 3]: one seam-exact
    EPF pass over the whole run, then the inverse colour transform (B is
    coded as a residual on Y)."""
    if epf:
        planes = epf_apply(planes, eff_mul, distance)
    planes = planes[:, :height, :width]
    x, y, b_res = planes[0], planes[1], planes[2]
    srgb = xyb_to_srgb(torch.stack([x, y, b_res + y], dim=-1))
    return torch.round(srgb * 255.0).to(torch.uint8)


def decode_striped_device(data: bytes, *, device) -> torch.Tensor:
    """Striped container -> RGB u8 [H, W, 3] tensor on `device`.

    Sections may mix coding families. Modular sections decode to RGB
    directly; each maximal run of consecutive VarDCT sections is stitched
    in plane space and gets its own EPF pass, applied when the majority of
    the run's sections signal EPF (at a VarDCT / modular boundary the edge
    is replicated, as at the image border). Raises ValueError when the
    sections disagree on the distance."""
    from jxl_tpu_torch.codec.decode import decode_bytes_device, decode_stream_planes

    dev = resolve_device(device)
    height, width, sections = read_striped(data)
    headers = [read_container_header(s) for s in sections]
    if all(h.lossless for h in headers):
        return torch.cat([decode_bytes_device(s, device=dev) for s in sections], dim=1)

    d0 = headers[0].distance
    if any(h.distance != d0 for h in headers):
        # a hand-built container: one distance would dequantise and filter
        # the other sections with the wrong strength
        raise ValueError("malformed striped container: sections disagree on distance")

    rgb_parts = []  # per modular section or VarDCT run: RGB u8 [H, part_w, 3]
    i = 0
    while i < len(sections):
        if headers[i].lossless:
            rgb_parts.append(decode_bytes_device(sections[i], device=dev))
            i += 1
            continue
        j = i
        planes_parts, mul_parts, epf_votes = [], [], 0
        while j < len(sections) and not headers[j].lossless:
            epf_votes += 1 if headers[j].epf else 0
            planes, eff_mul = decode_stream_planes(read_container(sections[j]), device=dev)
            planes_parts.append(planes)
            mul_parts.append(eff_mul)
            j += 1
        planes = torch.cat(planes_parts, dim=-1)
        rgb_parts.append(
            _stitch_finish(
                planes, torch.cat(mul_parts, dim=-1), d0, height=height, width=planes.shape[-1],
                epf=epf_votes * 2 > (j - i),
            )
        )
        i = j
    return torch.cat(rgb_parts, dim=1)[:, :width]


def decode_striped_bytes(data: bytes, *, device) -> np.ndarray:
    """Striped container -> RGB u8 [H, W, 3] numpy array (the work runs on
    `device`)."""
    return decode_striped_device(data, device=device).cpu().numpy()
