"""Kernel-regression merge helpers (counterparts of models/merge.py):
structure tensor -> merge-kernel inverse covariance (ComputeKernelParam)
and the weight-threshold normalization (ApplyWeighting)."""

from __future__ import annotations

import torch

from multi_frame_super_resolution_tpu_torch.config import MergeConfig
from multi_frame_super_resolution_tpu_torch.ops.derivatives import (
    derivatives,
    structure_tensor,
)
from multi_frame_super_resolution_tpu_torch.ops.filters import box_filter


def kernel_params(
    tensor: torch.Tensor, cfg: MergeConfig = MergeConfig(), eps: float = 1e-12
) -> torch.Tensor:
    """Structure tensor (..., 3) as (dx^2, dy^2, dxdy) -> Omega^-1 packed as
    (..., 3) = (inv_xx, inv_yy, inv_xy)."""
    a11 = tensor[..., 0]
    a22 = tensor[..., 1]
    a12 = tensor[..., 2]

    help_ = torch.sqrt((a22 - a11) ** 2 + 4.0 * a12 * a12)
    c = 2.0 * a12
    s = a22 - a11 + help_
    norm = torch.sqrt(c * c + s * s)
    safe = norm > 0
    c = torch.where(safe, c / torch.where(safe, norm, 1.0), 1.0)
    s = torch.where(safe, s / torch.where(safe, norm, 1.0), 0.0)

    lam1 = (a11 + a22 + help_) / 2.0
    lam2 = (a11 + a22 - help_) / 2.0

    a = 1.0 + torch.sqrt((lam1 - lam2) ** 2 / ((lam1 + lam2) ** 2).clamp_min(eps))
    d = (1.0 - torch.sqrt(lam1.clamp_min(0.0)) / cfg.d_tr + cfg.d_th).clamp(0.0, 1.0)

    k1h = cfg.k_detail * cfg.k_stretch * a
    k2h = cfg.k_detail / cfg.k_shrink * a
    k1 = ((1.0 - d) * k1h + d * cfg.k_detail * cfg.k_denoise) ** 2
    k2 = ((1.0 - d) * k2h + d * cfg.k_detail * cfg.k_denoise) ** 2
    k1 = k1.clamp(cfg.k_min, cfg.k_max)
    k2 = k2.clamp(cfg.k_min, cfg.k_max)

    x2, y2 = c, s
    x1, y1 = s, -c
    b11 = k1 * x1 * x1 + k2 * x2 * x2
    b12 = k1 * x1 * y1 + k2 * x2 * y2
    b22 = k1 * y1 * y1 + k2 * y2 * y2
    det = b11 * b22 - b12 * b12 + 1e-10
    return torch.stack([b22 / det, b11 / det, -b12 / det], dim=-1)


def apply_weighting(
    num: torch.Tensor,
    den: torch.Tensor,
    fallback: torch.Tensor,
    threshold: float,
) -> torch.Tensor:
    """Normalize the accumulators, blending in the fallback image where the
    accumulated weight is below threshold."""
    low = den < threshold
    num = torch.where(low, num + fallback, num)
    den = torch.where(low, den + 1.0, den)
    return torch.where(den != 0, num / torch.where(den != 0, den, 1.0), 0.0)


def smoothed_structure_tensor(gray: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Derivatives -> per-pixel structure tensor (H, W, 3), box-smoothed
    over a small window."""
    dx, dy = derivatives(gray)
    st = structure_tensor(dx, dy)
    if window > 1:
        st = box_filter(st, window, normalize=True)
    return st
