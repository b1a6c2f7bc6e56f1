"""Image source `synth_photo`: seeded synthetic photographs, made on the device.

A configuration names its image source in `images.source`; the source is
the module `perfbench/sources/<source>.py`, whose `images(spec, seed,
device)` returns the run's originals, RGB u8 [h, w, 3] tensors on the
device, from the configuration's `images` entry and the run's seed.

`synth_photo` is the recipe of `jxl_tpu_torch/tools/make_test_images.py:
synth_photo` (a smooth multi-scale base, blocky edges, two octaves of
band-limited noise and fine grain, tinted per channel), written in torch so
that a 12 MP frame is made on the card in milliseconds instead of seconds
of numpy. Its random draws come from a `torch.Generator` on the given
device, so the same (seed, index, device) always gives the same pixels; a
CPU run and a CUDA run give different pixels of the same kind.
"""

from __future__ import annotations

import torch


def image_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for image `index` of a run's `seed` (any
    whole number, large ones included)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 29)) & ((1 << 63) - 1)


def synth_photo(h: int, w: int, seed: int, device) -> torch.Tensor:
    """An RGB u8 [h, w, 3] photograph-like image on `device`."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))

    def uniform(lo, hi, n=1):
        return (lo + (hi - lo) * torch.rand(n, generator=g, device=dev)).tolist()

    def integer(lo, hi):
        return int(torch.randint(lo, hi, (1,), generator=g, device=dev))

    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    base = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for freq, amp in ((29.0, 0.25), (61.0, 0.15), (131.0, 0.2)):
        ph1, ph2 = uniform(0.0, 6.28, 2)
        base = base + amp * torch.sin(xx / freq + ph1) * torch.cos(yy / (freq * 0.8) + ph2)
    base = 0.55 + base

    bx, by = integer(48, 128), integer(32, 96)
    edges = 0.18 * (((xx // bx).to(torch.int64) ^ (yy // by).to(torch.int64)) % 2).to(torch.float32)

    tex = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for scale, amp in ((4, 0.02), (16, 0.03)):
        n = torch.randn((h // scale + 2, w // scale + 2), generator=g, device=dev)
        nn = n.repeat_interleave(scale, dim=0).repeat_interleave(scale, dim=1)[:h, :w]
        tex = tex + amp * nn
    tex = tex + 0.012 * torch.randn((h, w), generator=g, device=dev)

    lum = torch.clamp(base + edges + tex, 0.02, 0.98)
    (pr,), (pb,) = uniform(0.0, 6.0), uniform(0.0, 6.0)
    r = lum * (0.8 + 0.2 * torch.sin(yy / 97.0 + pr))
    b = lum * (0.7 + 0.3 * torch.cos(xx / 83.0 + pb))
    rgb = torch.stack([r, lum.expand_as(r), b], dim=-1)
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)


def images(spec: dict, seed: int, device) -> list:
    """`spec["count"]` images of `spec["height"]` x `spec["width"]` for a
    run's `seed`, on `device`."""
    h, w = int(spec["height"]), int(spec["width"])
    return [synth_photo(h, w, image_seed(seed, i), device) for i in range(int(spec["count"]))]

