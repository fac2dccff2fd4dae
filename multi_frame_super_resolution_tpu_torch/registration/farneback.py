"""Farneback dense optical flow by polynomial expansion (counterpart of
registration/farneback.py): six separable Gaussian-basis moments times
an inverse Gram matrix, then per pyramid level a few closed-form
smoothed 2 x 2 solves. Images are planes (..., H, W); a reference
broadcasts against the moving frames. Per-pixel coefficient fields are
kept as planes stacked on a leading axis, so each remap and each
smoothing filter runs once over all of them."""

from __future__ import annotations

import numpy as np
import torch

from multi_frame_super_resolution_tpu_torch.config import FlowConfig
from multi_frame_super_resolution_tpu_torch.ops.filters import (
    _const_array,
    gaussian_kernel_1d,
    separable_filter_planes,
)
from multi_frame_super_resolution_tpu_torch.ops.geometry import (
    downsample2_planes,
    identity_grid,
    remap_planes,
    resize,
)


def _poly_inv_gram(n: int, sigma: float) -> np.ndarray:
    """Inverse Gram matrix (float64 numpy, cast to float32) of the basis
    {1, x, y, x^2, y^2, xy} under Gaussian applicability over a
    (2n+1)^2 window."""
    xs = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(xs**2) / (2 * sigma * sigma))
    g /= g.sum()
    w = np.outer(g, g)  # (y, x)
    yy, xx = np.meshgrid(xs, xs, indexing="ij")
    basis = np.stack([np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy], axis=-1)
    gram = np.einsum("yxi,yxj,yx->ij", basis, basis, w)
    return np.linalg.inv(gram).astype(np.float32)


def _inv_gram_t(n: int, sigma: float) -> np.ndarray:
    return _poly_inv_gram(n, sigma).T.copy()


def _moment_taps(n: int, sigma: float):
    xs = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(xs**2) / (2 * sigma * sigma))
    g /= g.sum()
    return tuple((g * xs**k).astype(np.float32) for k in range(3))


def poly_expansion(img: torch.Tensor, n: int = 5, sigma: float = 1.1) -> torch.Tensor:
    """Per-pixel quadratic fit f(p + d) ~ d^T A d + b^T d + c of planes
    (..., H, W). Returns the coefficient planes (..., 5, H, W) ordered
    (axx, axy, ayy, bx, by), x-first as the JAX function's A (H, W, 2, 2)
    and b (H, W, 2) hold them (A[0, 1] = A[1, 0] = axy)."""
    k0, k1, k2 = _moment_taps(n, sigma)
    moments = torch.stack([
        separable_filter_planes(img, ky, kx)
        for ky, kx in ((k0, k0), (k0, k1), (k1, k0), (k0, k2), (k2, k0), (k1, k1))
    ], dim=-1)  # m1, mx, my, mxx, myy, mxy
    inv_gram_t = _const_array(_inv_gram_t, (n, sigma), img.device)
    coeffs = moments @ inv_gram_t  # (..., H, W, 6): c, bx, by, axx, ayy, axy
    return torch.stack([coeffs[..., 3], 0.5 * coeffs[..., 5], coeffs[..., 4], coeffs[..., 1], coeffs[..., 2]], dim=-3)


def _solve_displacement(c1: torch.Tensor, c2: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, win_size: int):
    """One Farneback update of the flow (fx, fy) (..., H, W): warp frame
    2's coefficient planes by the flow, average, and solve the smoothed
    2 x 2 normal equations with a relative ridge; NaN -> 0."""
    h, w = fx.shape[-2], fx.shape[-1]
    ys, xs = identity_grid(h, w, device=fx.device)
    c2w = remap_planes(c2, (ys + fy).unsqueeze(-3), (xs + fx).unsqueeze(-3))
    axx1, axy1, ayy1, bx1, by1 = c1.unbind(-3)
    axx2, axy2, ayy2, bx2, by2 = c2w.unbind(-3)
    axx = 0.5 * (axx1 + axx2)
    axy = 0.5 * (axy1 + axy2)
    ayy = 0.5 * (ayy1 + ayy2)
    dbx = -0.5 * (bx2 - bx1) + (axx * fx + axy * fy)
    dby = -0.5 * (by2 - by1) + (axy * fx + ayy * fy)
    # A^T A and A^T db of the symmetric A, smoothed as five planes at once
    m = torch.stack([
        axx * axx + axy * axy,
        axx * axy + axy * ayy,
        axy * axy + ayy * ayy,
        axx * dbx + axy * dby,
        axy * dbx + ayy * dby,
    ], dim=-3)
    g = gaussian_kernel_1d(win_size / 5.0, win_size)
    m11, m12, m22, v1, v2 = separable_filter_planes(m, g, g).unbind(-3)
    ridge = 1e-3 * (m11 + m22) + 1e-20
    m11 = m11 + ridge
    m22 = m22 + ridge
    det = m11 * m22 - m12 * m12
    new_fx = (m22 * v1 - m12 * v2) / det
    new_fy = (m11 * v2 - m12 * v1) / det
    return torch.nan_to_num(new_fx, nan=0.0), torch.nan_to_num(new_fy, nan=0.0)


def farneback_flow(ref: torch.Tensor, moved: torch.Tensor, cfg: FlowConfig = FlowConfig()) -> torch.Tensor:
    """Dense flows (..., H, W, 2) as (dy, dx) such that moved(x + flow) ~=
    ref(x), for ref (..., H, W) broadcasting against moved (..., H, W).
    The flow is carried as (dx, dy) inside, as in the JAX function."""
    ref_pyr, mov_pyr = [ref], [moved]
    for _ in range(cfg.pyramid_levels - 1):
        ref_pyr.append(downsample2_planes(ref_pyr[-1]))
        mov_pyr.append(downsample2_planes(mov_pyr[-1]))
    top = mov_pyr[-1]
    flow_xy = top.new_zeros(torch.broadcast_shapes(ref_pyr[-1].shape, top.shape) + (2,))
    for level in range(cfg.pyramid_levels - 1, -1, -1):
        r, m = ref_pyr[level], mov_pyr[level]
        if level != cfg.pyramid_levels - 1:
            flow_xy = resize(flow_xy, r.shape[-2], r.shape[-1], "bilinear") * 2.0
        c1 = poly_expansion(r, cfg.fb_poly_n, cfg.fb_poly_sigma)
        c2 = poly_expansion(m, cfg.fb_poly_n, cfg.fb_poly_sigma)
        fx, fy = flow_xy[..., 0], flow_xy[..., 1]
        for _ in range(cfg.fb_iterations):
            fx, fy = _solve_displacement(c1, c2, fx, fy, cfg.fb_win_size)
        flow_xy = torch.stack([fx, fy], dim=-1)
    return flow_xy.flip(-1)
