"""Erode (min filter) and dilate (max filter) over a size x size window of
the last two axes, and the per-pixel channel min (counterparts of
ops/morphology.py). Border windows reduce over the valid region only, as
the JAX SAME-padded reduce_window with an infinite init does; max_pool2d
pads with -inf likewise. A max over a rectangle is a max over its rows of
the max over its columns, exactly, so the window runs as two 1-D passes
(2*size instead of size^2 reads per pixel)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(img: torch.Tensor, size: int) -> torch.Tensor:
    if size % 2 != 1:
        raise ValueError(f"window size must be odd, got {size}")
    h, w = img.shape[-2], img.shape[-1]
    x = img.reshape(-1, 1, h, w)
    r = size // 2
    x = F.max_pool2d(x, (size, 1), stride=1, padding=(r, 0))
    x = F.max_pool2d(x, (1, size), stride=1, padding=(0, r))
    return x.reshape(img.shape)


def erode(img: torch.Tensor, size: int) -> torch.Tensor:
    return -dilate(-img, size)


def min_channels(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel min over the last (channel) axis."""
    return img.amin(dim=-1)
