"""The proposal side of the thesis's A/B, one caller: sweep rows under a list
of AC strategies.

Row after row, image after image with the configuration's efforts inner and
the mix's `strategies` innermost, each row runs exactly the calls and spans
of a `sweep_rows` row under its strategy (`encode_image_grid` over the
configuration's distances, `decode_bytes_grid_stacked` or stream by stream,
a synchronise, `metric_battery_grid_async` and its finalize); each judged
`Request` carries its row's strategy. One unit of work is a point.
"""

from __future__ import annotations

import torch

from perfbench.load import Reservoir, Window
from perfbench.loops import sweep_rows


class Loop:
    def __init__(self, cfg: dict, mix: dict, images: list, dev: torch.device):
        self.strategies = list(mix["strategies"])
        # one sweep_rows loop per strategy: the configuration with its codec's strategy replaced
        self.loops = [sweep_rows.Loop(dict(cfg, codec=dict(cfg["codec"], strategy=s)), mix, images, dev)
                      for s in self.strategies]
        self.next = 0

    def warm(self):
        """Every (effort, strategy) row of the first image."""
        for loop in self.loops:
            loop.warm()

    def step(self, win: Window, sample: Reservoir):
        row, k = divmod(self.next, len(self.loops))
        self.next += 1
        loop = self.loops[k]
        loop.next = row  # the sweep's row `row` (image-major, efforts inner), under strategy k
        loop.step(win, sample)
