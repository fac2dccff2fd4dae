"""Dual TV-L1 dense optical flow, the Zach-Pock-Bischof primal-dual
scheme (counterpart of registration/tvl1.py). The JAX function's
fixed-trip ``fori_loop``s are Python loops here. Images are planes
(..., H, W); a reference broadcasts against the moving frames. The flow
is carried as two planes stacked on a leading axis, (dy, dx), and the
dual field as four, (component, direction x/y), so that each step of
the scheme runs once over the stacked planes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multi_frame_super_resolution_tpu_torch.config import FlowConfig
from multi_frame_super_resolution_tpu_torch.ops.geometry import (
    downsample2_planes,
    identity_grid,
    remap_planes,
    resize,
)


def _grad_forward(u: torch.Tensor):
    """Forward differences of (..., H, W), zero at the far edge."""
    gx = F.pad(u[..., 1:] - u[..., :-1], (0, 1))
    gy = F.pad(u[..., 1:, :] - u[..., :-1, :], (0, 0, 0, 1))
    return gx, gy


def _div_backward(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, the negative adjoint of
    _grad_forward."""
    dx = torch.cat([px[..., :1], px[..., 1:] - px[..., :-1]], dim=-1)
    dy = torch.cat([py[..., :1, :], py[..., 1:, :] - py[..., :-1, :]], dim=-2)
    return dx + dy


def _tvl1_level(i0: torch.Tensor, i1: torch.Tensor, u: torch.Tensor, cfg: FlowConfig) -> torch.Tensor:
    """TV-L1 at one pyramid level: the flow u (2, ..., H, W), (dy, dx),
    refined so that i1(x + u(x)) ~= i0(x)."""
    h, w = i1.shape[-2], i1.shape[-1]
    ys, xs = identity_grid(h, w, device=i1.device)
    lt = cfg.tv_lambda * cfg.tv_theta
    tau_theta = cfg.tv_tau / cfg.tv_theta
    p = torch.zeros((2,) + u.shape, dtype=u.dtype, device=u.device)  # (direction x/y, component dy/dx, ...)
    for _ in range(cfg.tv_warps):
        sy = ys + u[0]
        sx = xs + u[1]
        # the warped image and its central differences: five bilinear
        # samples of i1, taken in one remap
        i1w, xp, xm, yp, ym = remap_planes(
            i1.unsqueeze(0),
            torch.stack([sy, sy, sy, sy + 1.0, sy - 1.0]),
            torch.stack([sx, sx + 1.0, sx - 1.0, sx, sx]),
        ).unbind(0)
        i1x = 0.5 * (xp - xm)
        i1y = 0.5 * (yp - ym)
        grad = torch.stack([i1y, i1x])
        grad_sq = i1x * i1x + i1y * i1y + 1e-9
        lo, hi = -lt * grad_sq, lt * grad_sq
        c = i1w - i0 - (i1x * u[1] + i1y * u[0])
        for _ in range(cfg.tv_iterations):
            rho = c + i1x * u[1] + i1y * u[0]
            # soft-thresholding step (v)
            step = torch.where(rho < lo, lt, torch.where(rho > hi, -lt, -rho / grad_sq))
            v = u + step * grad
            u = v + cfg.tv_theta * _div_backward(p[0], p[1])
            # dual ascent and projection
            p = p + tau_theta * torch.stack(_grad_forward(u))
            norm = torch.sqrt(p[0] * p[0] + p[1] * p[1]).clamp_min(1.0)
            p = p / norm
    bound = float(max(h, w))
    return u.clamp(-bound, bound)


def tvl1_flow(ref: torch.Tensor, moved: torch.Tensor, cfg: FlowConfig = FlowConfig()) -> torch.Tensor:
    """Dense flows (..., H, W, 2) as (dy, dx) with moved(x + flow) ~=
    ref(x), for ref (..., H, W) broadcasting against moved (..., H, W).
    The [0, 1] inputs are lifted to [0, 255], the range the classical
    step parameters assume."""
    ref = ref * 255.0
    moved = moved * 255.0
    ref_pyr, mov_pyr = [ref], [moved]
    for _ in range(cfg.pyramid_levels - 1):
        ref_pyr.append(downsample2_planes(ref_pyr[-1]))
        mov_pyr.append(downsample2_planes(mov_pyr[-1]))
    top = mov_pyr[-1]
    u = top.new_zeros(torch.broadcast_shapes(ref_pyr[-1].shape, top.shape) + (2,))
    for level in range(cfg.pyramid_levels - 1, -1, -1):
        r, m = ref_pyr[level], mov_pyr[level]
        if level != cfg.pyramid_levels - 1:
            u = resize(u, r.shape[-2], r.shape[-1], "bilinear") * 2.0
        u = torch.movedim(_tvl1_level(r, m, torch.movedim(u, -1, 0), cfg), 0, -1)
    return u
