"""Image derivatives and the structure tensor (counterparts of
ops/derivatives.py): 5-tap central differences, standard sign
(out = df/dx), replicate border.

The JAX names take the JAX call forms, images (H, W) or (H, W, C)
differentiated along axis 1 (x) and axis 0 (y). The ``_planes`` names
differentiate planes (..., H, W) along their last two axes, leading axes
a batch (the JAX package vmaps over them): the layout the pipelines use."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.ops.filters import (
    _filter_axis,
    _image_as_planes,
    _planes_as_image,
)

# correlation taps at offsets (-2, -1, 0, +1, +2)
_D5 = np.asarray([1.0, -8.0, 0.0, 8.0, -1.0], np.float32) / 12.0


def derivative5_x_planes(img: torch.Tensor) -> torch.Tensor:
    return _filter_axis(img, _D5, -1)


def derivative5_y_planes(img: torch.Tensor) -> torch.Tensor:
    return _filter_axis(img, _D5, -2)


def derivatives_planes(img: torch.Tensor):
    """(dx, dy) of planes (..., H, W)."""
    return derivative5_x_planes(img), derivative5_y_planes(img)


def derivatives_pair_planes(source: torch.Tensor, target: torch.Tensor):
    """(Ix, Iy, It) of planes, averaged over both frames, It = source -
    target."""
    ix = 0.5 * (derivative5_x_planes(source) + derivative5_x_planes(target))
    iy = 0.5 * (derivative5_y_planes(source) + derivative5_y_planes(target))
    return ix, iy, source - target


def derivative5_x(img: torch.Tensor) -> torch.Tensor:
    """d/dx (along axis 1) of an image (H, W) or (H, W, C)."""
    planes = _image_as_planes(img, "derivative5_x", "derivative5_x_planes")
    return _planes_as_image(derivative5_x_planes(planes), img)


def derivative5_y(img: torch.Tensor) -> torch.Tensor:
    """d/dy (along axis 0) of an image (H, W) or (H, W, C)."""
    planes = _image_as_planes(img, "derivative5_y", "derivative5_y_planes")
    return _planes_as_image(derivative5_y_planes(planes), img)


def derivatives(img: torch.Tensor):
    """(dx, dy) of an image (H, W) or (H, W, C)."""
    return derivative5_x(img), derivative5_y(img)


def derivatives_pair(source: torch.Tensor, target: torch.Tensor):
    """(Ix, Iy, It) of two images (H, W) or (H, W, C), averaged over both
    frames, It = source - target."""
    ix = 0.5 * (derivative5_x(source) + derivative5_x(target))
    iy = 0.5 * (derivative5_y(source) + derivative5_y(target))
    return ix, iy, source - target


def structure_tensor(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Per-pixel (dx^2, dy^2, dx*dy) stacked on the last axis."""
    return torch.stack([dx * dx, dy * dy, dx * dy], dim=-1)
