"""Erode (min filter) and dilate (max filter) over a size x size window of
the last two axes (counterparts of ops/morphology.py). Border windows
reduce over the valid region only, as the JAX SAME-padded reduce_window
with an infinite init does; max_pool2d pads with -inf likewise."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate(img: torch.Tensor, size: int) -> torch.Tensor:
    if size % 2 != 1:
        raise ValueError(f"window size must be odd, got {size}")
    h, w = img.shape[-2], img.shape[-1]
    x = img.reshape(-1, 1, h, w)
    out = F.max_pool2d(x, size, stride=1, padding=size // 2)
    return out.reshape(img.shape)


def erode(img: torch.Tensor, size: int) -> torch.Tensor:
    return -dilate(-img, size)
