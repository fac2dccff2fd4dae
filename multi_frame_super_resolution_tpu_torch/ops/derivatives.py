"""Image derivatives and the structure tensor (counterparts of
ops/derivatives.py): 5-tap central differences, standard sign
(out = df/dx), replicate border. Images are (..., H, W); leading axes
are a batch (the JAX package vmaps over them)."""

from __future__ import annotations

import numpy as np
import torch

from multi_frame_super_resolution_tpu_torch.ops.filters import _filter_axis

# correlation taps at offsets (-2, -1, 0, +1, +2)
_D5 = np.asarray([1.0, -8.0, 0.0, 8.0, -1.0], np.float32) / 12.0


def derivative5_x(img: torch.Tensor) -> torch.Tensor:
    return _filter_axis(img, _D5, -1)


def derivative5_y(img: torch.Tensor) -> torch.Tensor:
    return _filter_axis(img, _D5, -2)


def derivatives(img: torch.Tensor):
    """(dx, dy) of an image."""
    return derivative5_x(img), derivative5_y(img)


def derivatives_pair(source: torch.Tensor, target: torch.Tensor):
    """(Ix, Iy, It) averaged over both frames, It = source - target."""
    ix = 0.5 * (derivative5_x(source) + derivative5_x(target))
    iy = 0.5 * (derivative5_y(source) + derivative5_y(target))
    return ix, iy, source - target


def structure_tensor(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Per-pixel (dx^2, dy^2, dx*dy) stacked on the last axis."""
    return torch.stack([dx * dx, dy * dy, dx * dy], dim=-1)
