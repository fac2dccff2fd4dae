"""Color conversions (counterparts of ops/color.py)."""

from __future__ import annotations

import torch

from port_bench.reference.ops.filters import _const


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3) -> grayscale (...), BT.601 weights."""
    return img @ _const((0.299, 0.587, 0.114), img.device, img.dtype)


def srgb_gamma(img: torch.Tensor) -> torch.Tensor:
    """NaN-clean, clamp to [0, 1] and sRGB-encode."""
    img = torch.nan_to_num(img, nan=0.0).clamp(0.0, 1.0)
    low = 12.92 * img
    high = 1.055 * torch.pow(img.clamp_min(1e-8), 1.0 / 2.4) - 0.055
    return torch.where(img <= 0.0031308, low, high)


def srgb_degamma(img: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB encode of values clamped to [0, 1]."""
    img = img.clamp(0.0, 1.0)
    low = img / 12.92
    high = torch.pow((img + 0.055) / 1.055, 2.4)
    return torch.where(img <= 0.04045, low, high)


def normalize_minmax(img: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Min-max normalize to [lo, hi] over the whole tensor, the range
    floored at 1e-15 (cv::normalize NORM_MINMAX)."""
    mn = img.min()
    mx = img.max()
    return (img - mn) / (mx - mn).clamp_min(1e-15) * (hi - lo) + lo
