"""3x3 quadratic subpixel interpolation of an SSD minimum (counterpart of
registration/subpixel.py): the findMinimum least-squares surface fit."""

from __future__ import annotations

import numpy as np
import torch

from multi_frame_super_resolution_tpu_torch.ops.filters import _const

_FA11 = np.array([[1, -2, 1], [2, -4, 2], [1, -2, 1]], np.float32) / 4.0
_FA22 = _FA11.T.copy()
_FA12 = np.array([[1, 0, -1], [0, 0, 0], [-1, 0, 1]], np.float32) / 4.0
_FB1 = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0
_FB2 = _FB1.T.copy()


def quadratic_subpixel_min(patch: torch.Tensor) -> torch.Tensor:
    """Subpixel offset (dy, dx) in [-1, 1] of the minimum of a quadratic
    fit to ``patch`` (..., 3, 3); degenerate fits give 0 per axis."""
    f32 = patch.float()

    def corr(stencil):
        k = _const(tuple(stencil.reshape(-1).tolist()), f32.device).reshape(3, 3)
        return (f32 * k).sum(dim=(-2, -1))

    a11 = corr(_FA11).clamp_min(0.0)
    a22 = corr(_FA22).clamp_min(0.0)
    a12 = corr(_FA12)
    b1 = corr(_FB1)
    b2 = corr(_FB2)

    det = a11 * a22 - a12 * a12
    neg = det < 0
    a12 = torch.where(neg, 0.0, a12)
    det = torch.where(neg, a11 * a22, det)

    safe_det = torch.where(det == 0, 1.0, det)
    mu_x = torch.where(det != 0, (a22 * b1 - a12 * b2) / safe_det, 0.0)
    mu_y = torch.where(det != 0, (a11 * b2 - a12 * b1) / safe_det, 0.0)
    mu_x = torch.where(mu_x.abs() > 1.0, 0.0, mu_x)
    mu_y = torch.where(mu_y.abs() > 1.0, 0.0, mu_y)
    return torch.stack([-mu_y, -mu_x], dim=-1)
