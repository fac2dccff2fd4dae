"""FFT phase correlation for global translation estimation (counterpart of
registration/phase_correlation.py). ``phase_correlate`` takes the JAX
call form, two (H, W) images; ``phase_correlate_batched`` a batch of
second images (B, H, W), where the JAX package vmaps.

``argmax`` returns the first maximal index in both libraries, so integer
peaks agree wherever the two responses agree. The local matrix-DFT
refinement (``_dft_refine_peak``) evaluates the inverse DFT on a
1/upsample grid as two complex matrix products, here ``torch.matmul``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from port_bench.reference.ops.filters import _const_array
from port_bench.reference.ops.fourier import cross_power_spectrum
from port_bench.reference.registration.subpixel import quadratic_subpixel_min


def correlation_surface(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """fftshifted real phase-correlation response of images (..., H, W);
    the peak sits at center + (dy, dx) where b(x) ~= a(x + d)."""
    r = torch.fft.ifft2(cross_power_spectrum(torch.fft.fft2(a), torch.fft.fft2(b), eps))
    return torch.fft.fftshift(r.real, dim=(-2, -1))


def _peak_with_subpixel(resp: torch.Tensor, subpixel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Responses (B, H, W) -> (shifts (B, 2), peak values (B,))."""
    bsz, h, w = resp.shape
    flat = resp.reshape(bsz, h * w)
    idx = torch.argmax(flat, dim=1)
    py = idx // w
    px = idx % w
    peak = flat.gather(1, idx[:, None])[:, 0]
    shift = torch.stack([py.float() - h // 2, px.float() - w // 2], dim=1)
    if subpixel:
        cy = py.clamp(1, h - 2)
        cx = px.clamp(1, w - 2)
        offs = torch.arange(-1, 2, device=resp.device)
        rows = (cy[:, None, None] + offs[None, :, None]) * w
        patch = flat.gather(1, (rows + cx[:, None, None] + offs[None, None, :]).reshape(bsz, 9))
        sub = quadratic_subpixel_min(-patch.reshape(bsz, 3, 3))
        # only where the integer peak was not clamped at the border
        ok = (py >= 1) & (py <= h - 2) & (px >= 1) & (px <= w - 2)
        shift = shift + torch.where(ok[:, None], sub, 0.0)
    return shift, peak


def _fftfreq(n: int) -> np.ndarray:
    """jnp.fft.fftfreq(n) in float32, as JAX computes it (k / n)."""
    i = np.arange(n, dtype=np.float32)
    k = (i + n // 2) % n - n // 2
    return k.astype(np.float32) / np.float32(n)


def _refine_offsets(n: int, upsample: int) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32) - (n - 1) / 2.0) / upsample


def _dft_refine_peak(
    cps: torch.Tensor, shift_int: torch.Tensor, upsample: int, halfwidth: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local matrix-DFT peak refinement (Guizar-Sicairos et al. 2008): the
    inverse DFT of the normalized cross-power spectrum cps (B, H, W) on a
    1/upsample grid within +-halfwidth px of the integer peaks
    shift_int (B, 2). Returns (shifts (B, 2), peak values (B,))."""
    bsz, h, w = cps.shape
    n = 2 * int(round(halfwidth * upsample)) + 1
    offs = _const_array(_refine_offsets, (n, upsample), cps.device)
    two_pi = 2.0 * math.pi
    ys = shift_int[:, :1] + offs  # (B, n)
    xs = shift_int[:, 1:] + offs
    # the phases in JAX's order of products: (2 pi * ys) * fy, (2 pi * fx) * xs
    ang_y = (two_pi * ys)[:, :, None] * _const_array(_fftfreq, (h,), cps.device)  # (B, n, H)
    ang_x = (two_pi * _const_array(_fftfreq, (w,), cps.device))[:, None] * xs[:, None, :]  # (B, W, n)
    my = torch.complex(torch.cos(ang_y), torch.sin(ang_y))
    mx = torch.complex(torch.cos(ang_x), torch.sin(ang_x))
    r = torch.matmul(torch.matmul(my, cps), mx).real / (h * w)  # (B, n, n)
    flat = r.reshape(bsz, n * n)
    idx = torch.argmax(flat, dim=1)
    shift = torch.stack([ys.gather(1, (idx // n)[:, None])[:, 0],
                         xs.gather(1, (idx % n)[:, None])[:, 0]], dim=1)
    return shift, flat.gather(1, idx[:, None])[:, 0]


def phase_correlate_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    eps: float = 1e-15,
    subpixel: bool = True,
    window: torch.Tensor | None = None,
    refine: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translations (dy, dx) such that b(x) ~= a(x + d). a (H, W) or
    (B, H, W), b (B, H, W). Returns (shifts (B, 2), peak responses (B,)).
    ``refine`` > 1 replaces the 3x3 quadratic subpixel step with local
    matrix-DFT upsampling at that factor."""
    if window is not None:
        a = a * window
        b = b * window
    cps = cross_power_spectrum(torch.fft.fft2(a), torch.fft.fft2(b), eps)
    cps = cps.expand(b.shape[:-2] + cps.shape[-2:])
    resp = torch.fft.fftshift(torch.fft.ifft2(cps).real, dim=(-2, -1))
    if refine <= 1:
        return _peak_with_subpixel(resp, subpixel)
    shift_int, _ = _peak_with_subpixel(resp, subpixel=False)
    return _dft_refine_peak(cps, shift_int, refine)


def _check_pair(a: torch.Tensor, b: torch.Tensor, who: str) -> None:
    """Raise unless a and b are two (H, W) images, the JAX call form of
    ``who``, naming its batched form."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(
            f"{who} takes two (H, W) images, as the JAX function does, got shapes "
            f"{tuple(a.shape)} and {tuple(b.shape)}; use {who}_batched for a batch (B, H, W)"
        )


def phase_correlate(
    a: torch.Tensor,
    b: torch.Tensor,
    eps: float = 1e-15,
    subpixel: bool = True,
    window: torch.Tensor | None = None,
    refine: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The translation (dy, dx) such that b(x) ~= a(x + d) of two (H, W)
    images: (shift (2,), peak response, a 0-d tensor)."""
    _check_pair(a, b, "phase_correlate")
    shift, peak = phase_correlate_batched(a, b[None], eps, subpixel, window, refine)
    return shift[0], peak[0]
