"""Brox et al. variational optical flow (counterpart of
registration/brox.py): brightness and gradient constancy under a
robust penalty, coarse-to-fine warping, outer fixed-point
relinearizations, and under-relaxed Jacobi sweeps of the per-pixel 2 x 2
systems. The JAX function's ``fori_loop``s are Python loops here. Images
are planes (..., H, W); a reference broadcasts against the moving
frames."""

from __future__ import annotations

import torch

from multi_frame_super_resolution_tpu_torch.config import FlowConfig
from multi_frame_super_resolution_tpu_torch.ops.filters import _pad_edge, gaussian_blur_planes
from multi_frame_super_resolution_tpu_torch.ops.geometry import (
    downsample2_planes,
    identity_grid,
    remap_planes,
    resize,
)


def _dx(a: torch.Tensor) -> torch.Tensor:
    """Central difference along x with replicated borders."""
    ap = _pad_edge(a, -1, 1, 1)
    return 0.5 * (ap[..., 2:] - ap[..., :-2])


def _dy(a: torch.Tensor) -> torch.Tensor:
    ap = _pad_edge(a, -2, 1, 1)
    return 0.5 * (ap[..., 2:, :] - ap[..., :-2, :])


def _neighbors(a: torch.Tensor):
    """(up, down, left, right) of (..., H, W) with replicated borders."""
    ap = _pad_edge(_pad_edge(a, -2, 1, 1), -1, 1, 1)
    return ap[..., :-2, 1:-1], ap[..., 2:, 1:-1], ap[..., 1:-1, :-2], ap[..., 1:-1, 2:]


def _psi_deriv(s2: torch.Tensor, eps2: float) -> torch.Tensor:
    """psi'(s^2) = 1 / (2 sqrt(s^2 + eps^2)), the robust diffusivity."""
    return 0.5 * torch.rsqrt(s2 + eps2)


def _brox_level(i1: torch.Tensor, i2: torch.Tensor, u: torch.Tensor, v: torch.Tensor, cfg: FlowConfig):
    """One pyramid level: refined (u, v), the y- and x-flow planes, for
    the reference i1 and the moving i2."""
    h, w = i2.shape[-2], i2.shape[-1]
    ys, xs = identity_grid(h, w, device=i2.device)
    alpha = cfg.brox_alpha
    gamma = cfg.brox_gamma
    eps2 = cfg.brox_epsilon**2
    omega = cfg.brox_omega
    i1x, i1y = _dx(i1), _dy(i1)
    i2x = _dx(i2)
    # i2 and its five derivatives, sampled together by each warp
    derivs = torch.stack([i2, i2x, _dy(i2), _dx(i2x), _dy(i2x), _dy(_dy(i2))], dim=-3)
    for _ in range(cfg.brox_outer_iterations):
        uv = torch.stack([u, v])
        sampled = remap_planes(derivs, (ys + u).unsqueeze(-3), (xs + v).unsqueeze(-3))
        i2w, i2xw, i2yw, i2xxw, i2xyw, i2yyw = sampled.unbind(-3)
        iz = i2w - i1
        ixz = i2xw - i1x
        iyz = i2yw - i1y
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for _ in range(cfg.brox_inner_iterations):
            r_b = iz + i2xw * dv + i2yw * du
            r_gx = ixz + i2xxw * dv + i2xyw * du
            r_gy = iyz + i2xyw * dv + i2yyw * du
            psi_d = _psi_deriv(r_b * r_b + gamma * (r_gx * r_gx + r_gy * r_gy), eps2)
            ut = u + du
            vt = v + dv
            s2 = _dx(ut) ** 2 + _dy(ut) ** 2 + _dx(vt) ** 2 + _dy(vt) ** 2
            psi_s = _psi_deriv(s2, eps2)
            pu, pd, pl, pr = _neighbors(psi_s)
            wu, wd = 0.5 * (psi_s + pu), 0.5 * (psi_s + pd)
            wl, wr = 0.5 * (psi_s + pl), 0.5 * (psi_s + pr)
            wsum = wu + wd + wl + wr
            a11 = psi_d * (i2yw * i2yw + gamma * (i2xyw * i2xyw + i2yyw * i2yyw))
            a12 = psi_d * (i2xw * i2yw + gamma * (i2xyw * (i2xxw + i2yyw)))
            a22 = psi_d * (i2xw * i2xw + gamma * (i2xxw * i2xxw + i2xyw * i2xyw))
            b1 = -psi_d * (i2yw * iz + gamma * (i2xyw * ixz + i2yyw * iyz))
            b2 = -psi_d * (i2xw * iz + gamma * (i2xxw * ixz + i2xyw * iyz))
            m11 = a11 + alpha * wsum
            m22 = a22 + alpha * wsum
            det = m11 * m22 - a12 * a12
            # the sweeps on (du, dv) stacked: the diagonal entry that
            # multiplies each one's own right-hand side, (m22, m11)
            diag = torch.stack([m22, m11])
            b = torch.stack([b1, b2])
            d = torch.stack([du, dv])
            for _ in range(cfg.brox_solver_iterations):
                # smoothness couples each increment to the neighbours of (u + du)
                nu, nd, nl, nr = _neighbors(uv + d)
                smooth = wu * nu + wd * nd + wl * nl + wr * nr - wsum * uv
                rhs = b + alpha * smooth
                # the per-pixel 2 x 2 solve: du = (m22 rhs1 - a12 rhs2) / det,
                # dv = (m11 rhs2 - a12 rhs1) / det
                d_new = (diag * rhs - a12 * rhs.flip(0)) / det
                d = (1.0 - omega) * d + omega * d_new
            du, dv = d.unbind(0)
        u = u + du
        v = v + dv
    bound = float(max(h, w))
    return u.clamp(-bound, bound), v.clamp(-bound, bound)


def brox_flow(ref: torch.Tensor, moved: torch.Tensor, cfg: FlowConfig = FlowConfig()) -> torch.Tensor:
    """Dense Brox flows (..., H, W, 2) as (dy, dx), moved(x + flow) ~=
    ref(x), for ref (..., H, W) broadcasting against moved (..., H, W);
    both are presmoothed (sigma ``brox_presmooth``, 5 taps)."""
    ref = gaussian_blur_planes(ref, cfg.brox_presmooth, size=5)
    moved = gaussian_blur_planes(moved, cfg.brox_presmooth, size=5)
    ref_pyr, mov_pyr = [ref], [moved]
    for _ in range(cfg.pyramid_levels - 1):
        ref_pyr.append(downsample2_planes(ref_pyr[-1]))
        mov_pyr.append(downsample2_planes(mov_pyr[-1]))
    top = mov_pyr[-1]
    u = top.new_zeros(torch.broadcast_shapes(ref_pyr[-1].shape, top.shape))
    v = torch.zeros_like(u)
    for level in range(cfg.pyramid_levels - 1, -1, -1):
        r, m = ref_pyr[level], mov_pyr[level]
        if level != cfg.pyramid_levels - 1:
            uv = resize(torch.stack([u, v], dim=-1), r.shape[-2], r.shape[-1], "bilinear") * 2.0
            u, v = uv[..., 0], uv[..., 1]
        u, v = _brox_level(r, m, u, v, cfg)
    return torch.stack([u, v], dim=-1)
