"""A single-image caller above one section's pixel cap, one request at a
time: the striped JXTS path.

The `roundtrip` loop with the encode that `encode_file` calls for such a
frame: request after request, cycling over the images in order,
`tiled.encode_image_striped` at the configuration's distance, effort and
strategy with `default_n_stripes(h, w, stripe_mp)` stripes (the latency is
this call, to bytes returned), then `decode_bytes_device`, which routes the
wrapper to the striped decoder, and a synchronise. One unit of work is a
round trip of one image's megapixels.
"""

from __future__ import annotations

import time

import torch

from perfbench import spans
from perfbench.load import codec, sync
from perfbench.loops import roundtrip


def tiled():
    from jxl_tpu_torch.codec import tiled

    return tiled


class Loop(roundtrip.Loop):
    def __init__(self, cfg: dict, mix: dict, images: list, dev: torch.device):
        super().__init__(cfg, mix, images, dev)
        h, w = images[0].shape[:2]
        self.n_stripes = tiled().default_n_stripes(h, w, float(mix["stripe_mp"]))

    def _encode(self, i: int) -> bytes:
        return tiled().encode_image_striped(self.host[i], self.cfg, n_stripes=self.n_stripes, device=self.dev)

    def _trip(self, i: int):
        _c, _e, decode, _b = codec()
        t0 = time.perf_counter()
        with spans.span("encode"):
            data = self._encode(i)
        ms = (time.perf_counter() - t0) * 1e3
        with spans.span("decode"):
            pixels = decode.decode_bytes_device(data, device=self.dev)
            sync(self.dev)
        return data, pixels, ms

    def count_host_syncs(self, counter) -> int:
        """counter(fn) over one striped encode of the first image."""
        return counter(lambda: self._encode(0))
