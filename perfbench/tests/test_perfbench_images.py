"""The image generator: deterministic per seed, photographic."""

import numpy as np
import torch

from perfbench.sources.synth_photo import image_seed, images, synth_photo


def photo_set(h, w, count, seed, device):
    return images({"height": h, "width": w, "count": count}, seed, device)


def test_same_seed_same_pixels_other_seed_other_pixels():
    a = photo_set(64, 96, 3, 2**31 + 123, "cpu")
    b = photo_set(64, 96, 3, 2**31 + 123, "cpu")
    c = photo_set(64, 96, 3, 2**31 + 124, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert not torch.equal(a[0], a[1])


def test_large_seeds_and_indices_give_valid_generator_seeds():
    for seed in (0, 1, 2**31 - 1, 2**31 + 7, 2**40, 2**63 + 5):
        s = image_seed(seed, 23)
        assert 0 <= s < 2**63
    assert image_seed(5, 0) != image_seed(5, 1) != image_seed(6, 0)


def test_photographic_content():
    """Uint8 [h, w, 3] covering the range, with texture everywhere: no pixel
    run equals its west and north neighbours as text or graphics would."""
    img = synth_photo(128, 192, 77, "cpu")
    assert img.shape == (128, 192, 3) and img.dtype == torch.uint8
    a = img.numpy().astype(np.int32)
    assert a.min() < 60 and a.max() > 180
    eqw = (a[:, 1:] == a[:, :-1]).all(axis=2)
    eqn = (a[1:, :] == a[:-1, :]).all(axis=2)
    assert float(np.mean(eqw[1:, :] & eqn[:, 1:])) < 0.12
