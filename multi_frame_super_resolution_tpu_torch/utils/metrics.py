"""Image quality metrics (counterpart of utils/metrics.py): MSE, PSNR and
SSIM over a uniform window, in float32 on the device of the inputs."""

from __future__ import annotations

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    m = mse(a, b)
    return 10.0 * torch.log10((max_val * max_val) / m.clamp_min(1e-20))


def _box_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over each ``win`` x ``win`` window that lies wholly inside the
    (H, W) plane (a VALID box): a separable float32 sum, no convolution,
    so no TF32 on the card (the JAX package convolves at HIGHEST)."""
    rows = x.unfold(0, win, 1).sum(-1)
    return rows.unfold(1, win, 1).sum(-1) / float(win * win)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0, win: int = 7) -> torch.Tensor:
    """Mean structural similarity over a uniform window.

    Grayscale 2-D inputs (H, W) or (H, W, C), the mean of the channels'
    SSIM."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if a.ndim == 3:
        return torch.mean(torch.stack([ssim(a[..., c], b[..., c], max_val, win) for c in range(a.shape[-1])]))
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a = _box_valid(a, win)
    mu_b = _box_valid(b, win)
    mu_aa = _box_valid(a * a, win)
    mu_bb = _box_valid(b * b, win)
    mu_ab = _box_valid(a * b, win)
    var_a = mu_aa - mu_a * mu_a
    var_b = mu_bb - mu_b * mu_b
    cov = mu_ab - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)
