"""Erode (min filter) and dilate (max filter) over a size x size window,
and the per-pixel channel min (counterparts of ops/morphology.py).
Border windows reduce over the valid region only, as the JAX SAME-padded
reduce_window with an infinite init does; max_pool2d pads with -inf
likewise. A max over a rectangle is a max over its rows of the max over
its columns, exactly, so the window runs as two 1-D passes (2*size
instead of size^2 reads per pixel).

``dilate`` and ``erode`` reduce over axes 0 and 1 of (H, W, ...), as the
JAX functions do; ``dilate_planes`` and ``erode_planes`` over the last
two axes of planes (..., H, W), the layout the pipelines use."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate_planes(img: torch.Tensor, size: int) -> torch.Tensor:
    """Max filter over the last two axes of (..., H, W)."""
    if size % 2 != 1:
        raise ValueError(f"window size must be odd, got {size}")
    h, w = img.shape[-2], img.shape[-1]
    x = img.reshape(-1, 1, h, w)
    r = size // 2
    x = F.max_pool2d(x, (size, 1), stride=1, padding=(r, 0))
    x = F.max_pool2d(x, (1, size), stride=1, padding=(0, r))
    return x.reshape(img.shape)


def erode_planes(img: torch.Tensor, size: int) -> torch.Tensor:
    """Min filter over the last two axes of (..., H, W)."""
    return -dilate_planes(-img, size)


def _leading(fn, img: torch.Tensor, size: int) -> torch.Tensor:
    """``fn`` over axes 0 and 1 of (H, W, ...): the trailing axes ride
    in front as planes."""
    if img.ndim < 2:
        raise ValueError(f"morphology takes (H, W, ...) images, got shape {tuple(img.shape)}")
    if img.ndim == 2:
        return fn(img, size)
    planes = torch.movedim(img.reshape(img.shape[:2] + (-1,)), -1, 0)
    return torch.movedim(fn(planes, size), 0, -1).reshape(img.shape)


def dilate(img: torch.Tensor, size: int) -> torch.Tensor:
    """Max filter over a size x size window of axes 0 and 1 of (H, W, ...)."""
    return _leading(dilate_planes, img, size)


def erode(img: torch.Tensor, size: int) -> torch.Tensor:
    """Min filter over a size x size window of axes 0 and 1 of (H, W, ...)."""
    return _leading(erode_planes, img, size)


def min_channels(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel min over the last (channel) axis."""
    return img.amin(dim=-1)
