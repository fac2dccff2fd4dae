"""Kernel-regression merge (counterpart of models/merge.py): structure
tensor -> merge-kernel inverse covariance (ComputeKernelParam), the
gather-based merges of the oracle paths (accumulateImagesSuperRes: per
output pixel, a (2r+1)^2 window around the nearest sample of each frame
at its bilinear per-pixel flow, weighted by exp(-1/2 d^T Omega^-1 d) x
certainty), the weight-threshold normalizations (ApplyWeighting, order 0
and 1) and the two order-1 solves: the exact 3x3 normal equations and
the plugin-gradient centroid correction.

The gather merges run every frame at once: each tap's terms are added to
per-frame accumulators in tap order, and the frames' sums are then added
in frame order (the JAX scan adds each term to one running sum; the two
differ in rounding alone)."""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from port_bench.reference.config import MergeConfig
from port_bench.reference.ops.derivatives import (
    derivatives_planes,
    structure_tensor,
)
from port_bench.reference.ops.debayer import CFA, cfa_channel_map
from port_bench.reference.ops.filters import _const_array, box_filter_planes
from port_bench.reference.ops.geometry import resize


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


def _tap_weight(dy: torch.Tensor, dx: torch.Tensor, omega_inv: torch.Tensor) -> torch.Tensor:
    """exp(-1/2 (dx^2 Oxx + dy^2 Oyy + 2 dx dy Oxy)), NaN and +-inf to 0."""
    w = dx * dx * omega_inv[..., 0] + dy * dy * omega_inv[..., 1] + 2.0 * dx * dy * omega_inv[..., 2]
    return torch.nan_to_num(torch.exp(-0.5 * w), nan=0.0, posinf=0.0, neginf=0.0)


def _output_positions(sh: int, sw: int, scale: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Input-resolution positions of the output rows (sh, 1) and columns (sw,)."""
    py = (torch.arange(sh, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    px = (torch.arange(sw, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    return py[:, None], px


def _moment_terms(cw: torch.Tensor, cwv: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, order: int):
    """A tap's terms: (cwv, cw) at order 0; the 9 local-linear moments
    (solve_order1's order) at order 1."""
    if order == 0:
        return cwv, cw
    cwdy, cwdx = cw * dy, cw * dx
    return (cw, cwdy, cwdx, cwdy * dy, cwdy * dx, cwdx * dx, cwv, cwv * dy, cwv * dx)


def _sum_frames(acc) -> Tuple[torch.Tensor, ...]:
    """Per-frame accumulators (F, ...) -> their sums, frames added in order."""
    out = []
    for a in acc:
        total = a[0]
        for i in range(1, a.shape[0]):
            total = total + a[i]
        out.append(total)
    return tuple(out)


def merge_burst_rgb(
    burst: torch.Tensor,
    flows: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    scale: int,
    radius: int = 2,
    order: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Gather merge of an RGB burst onto the scale-x grid.

    burst (F, H, W, 3); flows (F, H, W, 2) in input pixels with
    frame_f(x + flow_f(x)) ~= ref(x); certainty (F, H, W, 3); omega_inv
    (H, W, 3). Each output pixel takes the (2r+1)^2 window around the
    nearest sample of each frame at its bilinearly resized flow;
    displacements are in output pixels, reads clamped at the borders.
    order=0: (num, den), each (sH, sW, 3); order=1: the 9 moment planes
    of solve_order1."""
    f, h, w = burst.shape[:3]
    sh, sw = h * scale, w * scale
    py, px = _output_positions(sh, sw, scale, burst.device)
    omega_out = resize(omega_inv, sh, sw, "bilinear")
    flow_out = resize(flows, sh, sw, "bilinear")  # (F, sH, sW, 2)
    qy = py + flow_out[..., 0]
    qx = px + flow_out[..., 1]
    ny = torch.round(qy).long()
    nx = torch.round(qx).long()
    img = burst.reshape(f, h * w, 3)
    cert = certainty.reshape(f, h * w, 3)
    acc = None
    for oy in range(-radius, radius + 1):
        for ox in range(-radius, radius + 1):
            ry, rx = ny + oy, nx + ox
            # output-grid displacements (the tap offsets are output steps)
            dy = (ry.float() - qy) * scale
            dx = (rx.float() - qx) * scale
            wgt = _tap_weight(dy, dx, omega_out)
            index = (ry.clamp(0, h - 1) * w + rx.clamp(0, w - 1)).reshape(f, -1, 1).expand(f, sh * sw, 3)
            vals = torch.gather(img, 1, index).reshape(f, sh, sw, 3)
            cert_s = torch.gather(cert, 1, index).reshape(f, sh, sw, 3)
            cw = wgt[..., None] * cert_s
            terms = _moment_terms(cw, vals * cw, dy[..., None], dx[..., None], order)
            acc = terms if acc is None else tuple(a + t for a, t in zip(acc, terms))
    return _sum_frames(acc)


def merge_burst_raw(
    raw_burst: torch.Tensor,
    flows: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    cfa: CFA,
    scale: int,
    radius: int = 2,
    order: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Gather merge of a Bayer RAW burst onto the scale-x grid
    (accumulateImagesSuperRes). raw_burst (F, H, W) normalized; flows
    (F, H, W, 2) in RAW pixels; certainty (F, H//2, W//2, 3) half-res;
    omega_inv (H, W, 3) at RAW resolution. Window reads are clamped to
    the mosaic first and the displacements taken from the clamped sample;
    each sample adds to its own CFA channel alone. order=0: (num, den),
    each (sH, sW, 3); order=1: the 9 moment planes of solve_order1."""
    f, h, w = raw_burst.shape
    sh, sw = h * scale, w * scale
    dev = raw_burst.device
    py, px = _output_positions(sh, sw, scale, dev)
    omega_out = resize(omega_inv, sh, sw, "bilinear")
    chan = _const_array(cfa_channel_map, (h, w, tuple(tuple(int(c) for c in r) for r in cfa)), dev).long()
    channels = torch.arange(3, device=dev)
    flow_out = resize(flows, sh, sw, "bilinear")
    qy = py + flow_out[..., 0]
    qx = px + flow_out[..., 1]
    ny = torch.round(qy).long()
    nx = torch.round(qx).long()
    hh, hw = certainty.shape[1], certainty.shape[2]
    raw = raw_burst.reshape(f, h * w)
    cert = certainty.reshape(f, hh * hw * 3)
    acc = None
    for oy in range(-radius, radius + 1):
        for ox in range(-radius, radius + 1):
            ry = (ny + oy).clamp(0, h - 1)
            rx = (nx + ox).clamp(0, w - 1)
            dy = (ry.float() - qy) * scale
            dx = (rx.float() - qx) * scale
            wgt = _tap_weight(dy, dx, omega_out)
            vals = torch.gather(raw, 1, (ry * w + rx).reshape(f, -1)).reshape(f, sh, sw)
            ch = chan[ry, rx]  # the CFA channel of each sample
            site = ((ry // 2) * hw + rx // 2) * 3 + ch
            cert_s = torch.gather(cert, 1, site.reshape(f, -1)).reshape(f, sh, sw)
            cw = torch.where(ch[..., None] == channels, (wgt * cert_s)[..., None], 0.0)
            terms = _moment_terms(cw, vals[..., None] * cw, dy[..., None], dx[..., None], order)
            acc = terms if acc is None else tuple(a + t for a, t in zip(acc, terms))
    return _sum_frames(acc)


def solve_order1(moments: Sequence[torch.Tensor], ridge: float = 0.02) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local-linear solve of the 9 moment planes (m00, m01, m02, m11, m12,
    m22, b0, b1, b2) -> (estimate, m00): the weighted normal equations
    [[m00 m01 m02] [m01 m11 m12] [m02 m12 m22]] (a, gy, gx) = (b0, b1, b2)
    by the adjugate, ``ridge`` * m00 added to the gradient diagonal;
    where |det| <= 1e-6 m00^3 the order-0 estimate b0 / m00 instead."""
    m00, m01, m02, m11, m12, m22, b0, b1, b2 = moments
    m11 = m11 + ridge * m00
    m22 = m22 + ridge * m00
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    det = m00 * c00 + m01 * c01 + m02 * c02
    a_num = c00 * b0 + c01 * b1 + c02 * b2
    order0 = torch.where(m00 > 1e-8, b0 / m00.clamp_min(1e-8), 0.0)
    good = det.abs() > 1e-6 * m00.clamp_min(1e-8) ** 3
    est = torch.where(good, a_num / torch.where(good, det, 1.0), order0)
    return est, m00


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
    dx, dy = derivatives_planes(gray)
    st = structure_tensor(dx, dy)
    if window > 1:
        st = torch.movedim(box_filter_planes(torch.movedim(st, -1, -3), window, normalize=True), -3, -1)
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
