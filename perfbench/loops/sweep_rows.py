"""The thesis RD sweep, one caller.

Row after row, image after image with the configuration's efforts inner,
each row runs the calls that `jxl_tpu_torch.bench.sweep.SweepRunner.
run_test_set` makes for one (image, effort): `encode_image_grid` over the
configuration's distances, `decode_bytes_grid_stacked`, a synchronise, then
`metric_battery_grid_async` and its finalize. One unit of work is a point.
"""

from __future__ import annotations

import torch

from perfbench import spans
from perfbench.load import Request, Reservoir, Window, codec, sync


class Loop:
    def __init__(self, cfg: dict, mix: dict, images: list, dev: torch.device):
        config, _e, _d, _b = codec()
        grid = cfg["grid"]
        self.distances = [float(d) for d in grid["distances"]]
        self.efforts = [int(e) for e in grid["efforts"]]
        self.strategy = cfg["codec"]["strategy"]
        self.cfgs = {e: config.CodecConfig(effort=e, strategy=config.Strategy[self.strategy]) for e in self.efforts}
        self.images, self.dev = images, dev
        self.host = [im.cpu().numpy() for im in images]
        self.rows = [(i, e) for i in range(len(images)) for e in self.efforts]
        self.mp = images[0].shape[0] * images[0].shape[1] / 1e6
        self.next = 0

    def _row(self, i: int, e: int):
        _c, encode, decode, battery = codec()
        with spans.span("encode"):
            datas = encode.encode_image_grid(self.host[i], self.cfgs[e], self.distances, device=self.dev)
        with spans.span("decode"):
            stacked = decode.decode_bytes_grid_stacked(datas, device=self.dev)
            if stacked is None:  # a row that is not uniform decodes stream by stream, as the runner does
                stacked = torch.stack([decode.decode_bytes_device(b, device=self.dev) for b in datas])
            sync(self.dev)
        with spans.span("battery"):
            rows = battery.metric_battery_grid_async(self.images[i], stacked)()
        return datas, stacked, rows

    def warm(self):
        """Every effort's row on the first image: the shapes the window uses."""
        for e in self.efforts:
            self._row(0, e)

    def step(self, win: Window, sample: Reservoir):
        i, e = self.rows[self.next % len(self.rows)]
        self.next += 1
        win.attempted += len(self.distances)
        datas, stacked, rows = self._row(i, e)
        win.units += len(datas)
        win.megapixels += self.mp * len(datas)
        win.containers.extend(datas)
        for j, d in enumerate(self.distances):
            sample.offer(lambda j=j, d=d: Request(i, d, e, self.strategy, datas[j], stacked[j], rows[j]))
