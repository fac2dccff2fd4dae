"""Kernel-regression merge helpers (counterparts of models/merge.py):
structure tensor -> merge-kernel inverse covariance (ComputeKernelParam),
the weight-threshold normalizations (ApplyWeighting, order 0 and 1) and
the plugin-gradient order-1 solve."""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

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


def grad_image(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient along the two LEADING spatial axes of
    (sH, sW, C), edge-clamped, output-pixel units."""
    up = torch.cat([img[:1], img[:-1]], dim=0)
    down = torch.cat([img[1:], img[-1:]], dim=0)
    left = torch.cat([img[:, :1], img[:, :-1]], dim=1)
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    return 0.5 * (down - up), 0.5 * (right - left)


def solve_plugin(
    moments: Sequence[torch.Tensor],
    grad_fn: Callable,
    iters: int = 2,
    precomputed_centroid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-order centroid-bias correction with a plugin gradient:
    est = pilot - grad(est) . c, iterated ``iters`` times from the pilot
    b0 / m00. ``moments`` is the 9-stack (slots 0, 1, 2, 6 used) or the
    4-stack (m00, m01, m02, b0); with ``precomputed_centroid`` slots 1/2
    already hold the clipped centroid (cy, cx), as the certless RAW merge
    returns them. ``grad_fn(img) -> (gy, gx)`` works in the estimate's
    own layout (grad_image, fast_merge.grad_phases). Returns (est, m00)."""
    m00, m01, m02 = moments[0], moments[1], moments[2]
    b0 = moments[6] if len(moments) == 9 else moments[3]
    inv = torch.where(m00 > 1e-8, 1.0 / m00.clamp_min(1e-8), 0.0)
    pilot = b0 * inv
    if precomputed_centroid:
        cy, cx = m01, m02
    else:
        cy = (m01 * inv).clamp(-2.0, 2.0)
        cx = (m02 * inv).clamp(-2.0, 2.0)
    est = pilot
    for _ in range(max(iters, 0)):
        gy, gx = grad_fn(est)
        est = pilot - (gy * cy + gx * cx)
    return est, m00


def apply_weighting_order1(
    est: torch.Tensor, m00: torch.Tensor, fallback: torch.Tensor, threshold: float
) -> torch.Tensor:
    """ApplyWeighting for the (already normalized) order-1 estimate:
    below-threshold coverage blends toward the fallback,
    out = (est * m00 + fallback) / (m00 + 1)."""
    low = m00 < threshold
    return torch.where(low, (est * m00 + fallback) / (m00 + 1.0), est)
