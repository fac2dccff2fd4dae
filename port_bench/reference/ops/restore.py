"""Post-merge restoration FIR and its noise gate (counterpart of
ops/restore.py): the separable polyphase form on channel-leading phase
planes, the output-resolution form of the gather (oracle) paths, the
registered temporal noise statistic and the gate's gain.

ops/restore.py imports jax at module level, so its constants are carried
across here: a copy of the fitted 7x7 kernel, and ``restore_factors``,
which rebuilds the shipped rank-2 kernel and its separable factors with
the same float64 SVD.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from port_bench.reference.ops.filters import _pad_edge

# fit by tools/fit_restore.py on the order-1 fast RAW pipeline output
# (city burst, seed 7, 2x); DC-normalized, 4-fold symmetric
RESTORE_KERNEL_FIT = np.array([
    [0.004845, -0.028202, -0.016631, -0.007837, -0.016631, -0.028202, 0.004845],
    [-0.028286, -0.001758, -0.025565, -0.048270, -0.025565, -0.001758, -0.028286],
    [-0.016577, -0.025510, 0.010336, 0.234416, 0.010336, -0.025510, -0.016577],
    [-0.007857, -0.048323, 0.234462, 0.796216, 0.234462, -0.048323, -0.007857],
    [-0.016577, -0.025510, 0.010336, 0.234416, 0.010336, -0.025510, -0.016577],
    [-0.028286, -0.001758, -0.025565, -0.048270, -0.025565, -0.001758, -0.028286],
    [0.004845, -0.028202, -0.016631, -0.007837, -0.016631, -0.028202, 0.004845],
], dtype=np.float32)


def restore_factors(kernel_fit: np.ndarray) -> Tuple[np.ndarray, tuple]:
    """The DC-renormalized rank-2 truncated SVD of ``kernel_fit``:
    (kernel (7, 7) float32, ((uy_r, vx_r) for r in 0, 1)) with
    sum_r outer(uy_r, vx_r) == kernel."""
    u, sv, vt = np.linalg.svd(np.asarray(kernel_fit).astype(np.float64))
    k2 = (u[:, :2] * sv[:2]) @ vt[:2]
    kernel = (k2 / k2.sum()).astype(np.float32)
    factors = tuple(
        ((u[:, r] * sv[r] / k2.sum()).astype(np.float32), vt[r].astype(np.float32))
        for r in range(2)
    )
    return kernel, factors


RESTORE_KERNEL, RESTORE_FACTORS = restore_factors(RESTORE_KERNEL_FIT)


def _host_kernel(kernel) -> np.ndarray:
    """A FIR given as numpy or as a tensor on any device, as float32
    numpy: its taps are the scalar coefficients of the tap loops."""
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().cpu().numpy()
    return np.asarray(kernel, np.float32)


def restore_image(
    img: torch.Tensor, kernel: Optional[np.ndarray] = None, gain: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """A restoration FIR at output resolution on (H, W, C) or (H, W),
    edge-clamped: out[y, x] = sum_uv k[u, v] img[y - u + r, x - v + r], a
    true convolution, its terms summed in the JAX order. ``kernel`` (kh,
    kw) defaults to the shipped ``RESTORE_KERNEL``. ``gain``: a 0-d
    tensor g; returns img + g * (restored - img)."""
    if gain is not None:
        return img + gain * (restore_image(img, kernel) - img)
    k = RESTORE_KERNEL if kernel is None else _host_kernel(kernel)
    kh, kw = k.shape
    r_y, r_x = kh // 2, kw // 2
    chan = img.ndim == 3
    x = torch.movedim(img, -1, 0) if chan else img
    h, w = x.shape[-2], x.shape[-1]
    pad = max(r_y, r_x, 1)
    xp = _pad_edge(_pad_edge(x, -2, pad, pad), -1, pad, pad)
    out = None
    for u in range(kh):
        for v in range(kw):
            c = float(k[u, v])
            if c == 0.0:
                continue
            dy, dx = r_y - u, r_x - v
            term = xp[..., pad + dy : pad + dy + h, pad + dx : pad + dx + w] * c
            out = term if out is None else out + term
    return torch.movedim(out, 0, -1) if chan else out


def _polyphase_taps_1d(v: np.ndarray, n: int):
    """1-D polyphase tap table for total upsampling factor n:
    W[p, q, m] such that out_p[i] = sum_q sum_m W[p, q, m] plane_q[i + m]
    (spatial index offset by +m_rad)."""
    kh = len(v)
    r = kh // 2
    m_rad = (r + n - 1) // n
    w = np.zeros((n, n, 2 * m_rad + 1), np.float32)
    for p in range(n):
        for t in range(-r, r + 1):
            q, m = (p - t) % n, (p - t) // n
            w[p, q, m + m_rad] += v[t + r]
    return w, m_rad


def _polyphase_conv_kernel(k: np.ndarray, n: int):
    """Dense polyphase tap table of a (kh, kh) kernel for total upsampling
    factor n: W[p, q, my, mx] such that out_p[i, j] = sum_q sum_m
    W[p, q, m] plane_q[i + my, j + mx], phases p = py n + px, the spatial
    index offset by +m_rad."""
    kh = k.shape[0]
    r = kh // 2
    m_rad = (r + n - 1) // n
    mk = 2 * m_rad + 1
    w = np.zeros((n * n, n * n, mk, mk), np.float32)
    for py in range(n):
        for px in range(n):
            for ty in range(-r, r + 1):
                qy, my = (py - ty) % n, (py - ty) // n
                for tx in range(-r, r + 1):
                    qx, mx = (px - tx) % n, (px - tx) // n
                    w[py * n + px, qy * n + qx, my + m_rad, mx + m_rad] += k[ty + r, tx + r]
    return w, m_rad


def restore_phases(
    planes: torch.Tensor, kernel: Optional[np.ndarray] = None, gain: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """A restoration FIR on channel-leading phase planes (n, n, C, H, W),
    plane (p, q) holding output pixels (n*i + p, n*j + q), each plane
    edge-clamped. The shipped kernel (``kernel=None``) is lowered
    separably, as the JAX function's default branch does; another
    (kh, kh) kernel through its dense polyphase tap table. ``gain``: a
    0-d tensor g in [0, 1]; returns the gated lerp (1 - g) * planes + g *
    restored (fused into the accumulation for the shipped kernel)."""
    if kernel is None:
        return _restore_phases_separable(planes, RESTORE_FACTORS, gain=gain)
    if gain is not None:
        return planes + gain * (restore_phases(planes, kernel) - planes)
    n, _, c, h, w = planes.shape
    wk, m_rad = _polyphase_conv_kernel(_host_kernel(kernel), n)
    xpad = _pad_edge(_pad_edge(planes.reshape(n * n, c, h, w), -2, m_rad, m_rad), -1, m_rad, m_rad)
    outs = []
    for p in range(n * n):
        acc = None
        for q in range(n * n):
            for my in range(2 * m_rad + 1):
                for mx in range(2 * m_rad + 1):
                    coef = float(wk[p, q, my, mx])
                    if coef == 0.0:
                        continue
                    term = coef * xpad[q, :, my : my + h, mx : mx + w]
                    acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, 0).reshape(n, n, c, h, w)


def _restore_phases_separable(
    planes: torch.Tensor, factors, gain: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per rank (uy, vx): a 1-D x-pass then a 1-D y-pass over the phase
    planes, edge-clamped per plane, ranks summed. Each output phase sums
    its taps in the JAX order; the y-pass runs all x-phases at once."""
    n = planes.shape[0]
    h, w = planes.shape[-2], planes.shape[-1]
    out = None
    if gain is not None:
        out = [(1.0 - gain) * planes[p] for p in range(n)]  # each (n_x, C, H, W)
    for uy, vx in factors:
        wx, mx_rad = _polyphase_taps_1d(np.asarray(vx, np.float32), n)
        wy, my_rad = _polyphase_taps_1d(np.asarray(uy, np.float32), n)
        xpad = _pad_edge(planes, -1, mx_rad, mx_rad)
        xp = []  # x-filtered, indexed by output x-phase: (n_yin, C, H, W)
        for p in range(n):
            acc = None
            for q in range(n):
                for m in range(2 * mx_rad + 1):
                    coef = float(wx[p, q, m])
                    if coef == 0.0:
                        continue
                    term = coef * xpad[:, q, ..., m : m + w]
                    acc = term if acc is None else acc + term
            xp.append(acc)
        ypad = _pad_edge(torch.stack(xp, 0), -2, my_rad, my_rad)  # (n_x, n_yin, C, ., W)
        for p in range(n):
            acc = None
            for q in range(n):
                for m in range(2 * my_rad + 1):
                    coef = float(wy[p, q, m])
                    if coef == 0.0:
                        continue
                    cf = coef if gain is None else coef * gain
                    term = cf * ypad[:, q, :, m : m + h]
                    acc = term if acc is None else acc + term
            if out is None:
                out = [None] * n
            out[p] = acc if out[p] is None else out[p] + acc
    return torch.stack(out, 0)


def temporal_noise_stat(
    gray: torch.Tensor,
    flows: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    step: int = 8,
) -> torch.Tensor:
    """Robust per-burst noise statistic from REGISTERED luma frames
    (F, H, W), frame 0 the reference: the 15th percentile of
    |alt - ref + residual . grad(ref)| over the flattest 30% of a
    ``step``-subsampled grid and all alternates. ``residual``
    (F-1, H, W, 2) is the subpixel flow left after registration.
    ``flows`` (F, H, W, 2) instead registers unwarped frames, as the
    gather (oracle) paths do: each alternate is shifted by its rounded
    flow, edge-clamped, and the residual is flows - round(flows).
    Returns a 0-d tensor."""
    ref = gray[0]
    moved = gray[1:]
    if flows is not None:
        h, w = ref.shape
        dev = ref.device
        rounded = torch.round(flows[1:])
        yi = (torch.arange(h, device=dev)[:, None] + rounded[..., 0].long()).clamp_(0, h - 1)
        xi = (torch.arange(w, device=dev) + rounded[..., 1].long()).clamp_(0, w - 1)
        moved = torch.gather(moved.reshape(moved.shape[0], -1), 1, (yi * w + xi).reshape(moved.shape[0], -1))
        moved = moved.reshape(gray[1:].shape)
        residual = flows[1:] - rounded
    gy, gx = torch.gradient(ref)
    d = moved - ref
    if residual is not None:
        d = d + residual[..., 0] * gy + residual[..., 1] * gx
    d = d.abs()[:, 1:-1, 1:-1]
    step = max(1, min(step, min(d.shape[-2], d.shape[-1]) // 8))
    gm = gy.abs() + gx.abs()
    gm_s = gm[1:-1, 1:-1][::step, ::step]
    d_s = d[:, ::step, ::step]
    t = torch.quantile(gm_s.reshape(-1), 0.30)
    d_masked = torch.where(gm_s[None] <= t, d_s, torch.inf)
    return torch.quantile(d_masked.reshape(-1), 0.15)


def restore_gain(stat: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Noise-adaptive restoration strength: 1 below ``lo``, 0 above
    ``hi``, linear in between."""
    return ((hi - stat) / max(hi - lo, 1e-9)).clamp(0.0, 1.0)
