"""Static-tap kernel-regression merge (counterpart of models/fast_merge.py),
order 0: the plain PyTorch version of the merge kernel
(kernels/merge.py, csrc/merge.cu).

Frames arrive warped into reference geometry by their per-tile integer
shifts; what remains per output pixel is a static tap window around its
nearest input sample, with the bounded subpixel residual folded into the
Gaussian weights. All s^2 output phases are accumulated at input
resolution and interleaved once at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multi_frame_super_resolution_tpu_torch.ops.warp_fast import _pad_last2, _shifted


def _output_phase_offsets(s: int) -> np.ndarray:
    """phi(o % s) = (o + 0.5)/s - 0.5 - o//s: the constant fractional
    position of each output phase relative to its nearest input sample."""
    o = np.arange(s, dtype=np.float32)
    return (o + 0.5) / s - 0.5


# taps whose best-case weight is below e^-6 are dropped: the threshold
# merge_fast_pallas uses (its _active_taps call takes the default)
_PRUNE_EXP = 6.0


def _active_taps(r_taps: int, residual_bound: float, scale: int, k_max: float):
    """Static tap pruning: keep taps whose best-case Gaussian weight
    exceeds e^-_PRUNE_EXP, with |d|_min per axis = max(0, |k| - rb -
    max|phi|) * s in output-grid units and the largest clamped kernel
    variance k_max."""
    phi_max = float(np.max(np.abs(_output_phase_offsets(scale))))
    taps = []
    for ky in range(-r_taps, r_taps + 1):
        for kx in range(-r_taps, r_taps + 1):
            dy = max(0.0, abs(ky) - residual_bound - phi_max) * scale
            dx = max(0.0, abs(kx) - residual_bound - phi_max) * scale
            if (dy * dy + dx * dx) / (2.0 * max(k_max, 1e-6)) <= _PRUNE_EXP:
                taps.append((ky, kx))
    return taps


def merge_burst_fast(
    warped: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge tile-warped RGB frames onto the scale-x output grid.

    warped (F, H, W, 3); residual (F, H, W, 2) subpixel flow, clamped to
    +-residual_bound; certainty (F, H, W, 3); omega_inv (H, W, 3).
    Returns (num, den), each (sH, sW, 3).

    The frame axis is a batch dimension: each frame's taps are summed in
    tap order and the frames are then added in order, the summation
    order of the JAX scan.
    """
    f, h, w = warped.shape[:3]
    s = scale
    r_taps = radius + int(np.ceil(residual_bound))
    taps = _active_taps(r_taps, residual_bound, s, k_max)
    phi = _output_phase_offsets(s)

    oxx = omega_inv[..., 0]
    oyy = omega_inv[..., 1]
    oxy = omega_inv[..., 2]
    # channel-leading planes, edge-padded once: every tap is a view
    img = _pad_last2(torch.movedim(warped, -1, 1), r_taps, r_taps)  # (F, 3, H+2r, W+2r)
    cert = _pad_last2(torch.movedim(certainty, -1, 1), r_taps, r_taps)
    res_y = residual[..., 0].clamp(-residual_bound, residual_bound)  # (F, H, W)
    res_x = residual[..., 1].clamp(-residual_bound, residual_bound)

    acc_n = [[None] * s for _ in range(s)]
    acc_d = [[None] * s for _ in range(s)]
    for ky, kx in taps:
        val = _shifted(img, r_taps, ky, kx, h, w)
        cert_k = _shifted(cert, r_taps, ky, kx, h, w)
        dy0 = (ky - res_y) * s
        dx0 = (kx - res_x) * s
        for py in range(s):
            dy = dy0 - float(phi[py] * s)
            for px in range(s):
                dx = dx0 - float(phi[px] * s)
                wgt = torch.exp(
                    -0.5 * (dx * dx * oxx + dy * dy * oyy + 2.0 * dx * dy * oxy)
                )
                cw = wgt[:, None] * cert_k
                cwv = val * cw
                if acc_n[py][px] is None:
                    acc_n[py][px], acc_d[py][px] = cwv, cw
                else:
                    acc_n[py][px] = acc_n[py][px] + cwv
                    acc_d[py][px] = acc_d[py][px] + cw

    def interleave(acc):
        # (s, s, F, 3, H, W) -> frames summed in order -> (sH, sW, 3)
        stack = torch.stack([torch.stack(row, 0) for row in acc], 0)
        total = stack[:, :, 0]
        for i in range(1, f):
            total = total + stack[:, :, i]
        return total.permute(3, 0, 4, 1, 2).reshape(h * s, w * s, 3)

    return interleave(acc_n), interleave(acc_d)
