"""A single-image caller (cjxl-like), one request at a time.

Request after request, cycling over the images in order: `encode_image` at
the configuration's distance, effort and strategy (the latency is this
call, to bytes returned), then `decode_bytes_device` and a synchronise. One
unit of work is a round trip of one image's megapixels.
"""

from __future__ import annotations

import time

import torch

from perfbench import spans
from perfbench.load import Request, Reservoir, Window, codec, sync


class Loop:
    def __init__(self, cfg: dict, mix: dict, images: list, dev: torch.device):
        config, _e, _d, _b = codec()
        c = cfg["codec"]
        self.distance, self.effort, self.strategy = float(c["distance"]), int(c["effort"]), c["strategy"]
        self.cfg = config.CodecConfig(distance=self.distance, effort=self.effort,
                                      strategy=config.Strategy[self.strategy])
        self.images, self.dev = images, dev
        self.host = [im.cpu().numpy() for im in images]
        self.mp = images[0].shape[0] * images[0].shape[1] / 1e6
        self.next = 0

    def _trip(self, i: int):
        _c, encode, decode, _b = codec()
        t0 = time.perf_counter()
        with spans.span("encode"):
            data = encode.encode_image(self.host[i], self.cfg, device=self.dev)
        ms = (time.perf_counter() - t0) * 1e3
        with spans.span("decode"):
            pixels = decode.decode_bytes_device(data, device=self.dev)
            sync(self.dev)
        return data, pixels, ms

    def warm(self):
        """Two round trips of the first image: every kernel and op the
        window runs meets its shapes once before it."""
        for _ in range(2):
            self._trip(0)

    def count_host_syncs(self, counter) -> int:
        """counter(fn) over one encode of the first image."""
        _c, encode, _d, _b = codec()
        return counter(lambda: encode.encode_image(self.host[0], self.cfg, device=self.dev))

    def step(self, win: Window, sample: Reservoir):
        i = self.next % len(self.images)
        self.next += 1
        win.attempted += 1
        data, pixels, ms = self._trip(i)
        win.encode_ms.append(ms)
        win.units += 1
        win.megapixels += self.mp
        win.containers.append(data)
        sample.offer(lambda: Request(i, self.distance, self.effort, self.strategy, data, pixels))
