"""Fourier-domain ops (counterparts of ops/fourier.py): fftshift,
apodization, high-pass, cross-power spectrum, radial fourier filter.

The FFTs are ``torch.fft`` (cuFFT on the card). The windows and masks
are built in numpy exactly as the JAX package builds them and copied to
a device once per (shape, device) by ``ops.filters._const_array``, so a
call makes no host-to-device copy.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.ops.filters import _const_array


def fftshift2(x: torch.Tensor) -> torch.Tensor:
    """Quadrant-swap fftshift over the last two dims."""
    return torch.fft.fftshift(x, dim=(-2, -1))


def ifftshift2(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifftshift(x, dim=(-2, -1))


def fftshift_signflip(x: torch.Tensor) -> torch.Tensor:
    """Multiply the spatial image by (-1)^(y+x) so its FFT comes out
    centered."""
    h, w = x.shape[-2], x.shape[-1]
    dtype = x.dtype if x.dtype.is_floating_point else torch.float32
    iy = torch.arange(h, device=x.device)[:, None]
    ix = torch.arange(w, device=x.device)[None, :]
    return x * (1.0 - 2.0 * ((iy + ix) % 2).to(dtype))


def apodization_window(rows: int, cols: int, radius: int) -> np.ndarray:
    """Hanning-edged 2-D apodization window as the outer product a * b: a
    Hann ramp of length 2 radius split across the leading and trailing
    edges, ones between (getApodizationWindow)."""
    size = 2 * radius
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(size) / (size - 1))
    a = np.ones(rows, np.float32)
    a[:radius] = hann[:radius]
    a[rows - radius :] = hann[radius:]
    b = np.ones(cols, np.float32)
    b[:radius] = hann[:radius]
    b[cols - radius :] = hann[radius:]
    return np.outer(a, b).astype(np.float32)


def high_pass_filter(rows: int, cols: int) -> np.ndarray:
    """Radial high-pass 1 - cos^2(sqrt(t1^2 + t2^2)) over
    [-pi/2, pi/2]^2 (getHighPassFilter)."""
    t1 = (np.arange(rows) * (np.pi / (rows - 1)) - np.pi / 2.0) ** 2
    t2 = (np.arange(cols) * (np.pi / (cols - 1)) - np.pi / 2.0) ** 2
    r = np.sqrt(t1[:, None] + t2[None, :])
    return (1.0 - np.cos(r) ** 2).astype(np.float32)


def cross_power_spectrum(fa: torch.Tensor, fb: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """Normalized cross-power spectrum fa conj(fb) / (|fa conj(fb)| + eps).
    The real and imaginary parts are divided by the real denominator one
    by one, as XLA's complex division by a real-valued complex does."""
    prod = fa * torch.conj(fb)
    den = torch.abs(prod) + eps
    return torch.complex(prod.real / den, prod.imag / den)


def conj_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conj(a) * b, the FFT cross-correlation core."""
    return torch.conj(a) * b


def fourier_filter_mask(
    height: int,
    width: int,
    lp: float,
    hp: float,
    lps: float,
    hps: float,
    clear_axis: int = 0,
) -> np.ndarray:
    """Radial low/high-pass mask with Gaussian skirts for an R2C half
    spectrum of shape (height, width // 2 + 1) (fourierFilter).
    Frequencies are normalized by the image size; the first
    ``clear_axis`` rows and columns near the axes are optionally zeroed."""
    half_w = width // 2 + 1
    mx = np.arange(half_w, dtype=np.float32) / width
    my = np.arange(height, dtype=np.float32)
    my = np.where(my > height * 0.5, (height - my) * -1.0, my) / height
    dist = np.sqrt(mx[None, :] ** 2 + my[:, None] ** 2)

    lp_eff = lp - lps
    hp_eff = hp + hps
    if lp_eff > 0:
        fil = np.where(dist <= lp_eff, 1.0, 0.0)
    else:
        fil = np.where(dist <= 1.0, 1.0, 0.0)
    if lps > 0:
        fil2 = np.where(dist < lp_eff, 1.0, 0.0)
        fil2 = (1.0 - fil2) * np.exp(-((dist - lp_eff) ** 2) / (2 * lps * lps))
        fil = np.where(fil2 > 0.001, fil2, fil)
    if lps > 0 and lp_eff == 0 and hp_eff == 0 and hps == 0:
        fil = np.exp(-((dist - lp_eff) ** 2) / (2 * lps * lps))
    if hp_eff > 0:
        fil2 = np.where(dist >= hp_eff, 1.0, 0.0)
        fil = fil * fil2
        if hps > 0:
            fil3 = (1.0 - fil2) * np.exp(-((dist - hp_eff) ** 2) / (2 * hps * hps))
            fil = np.where(fil3 > 0.001, fil3, fil)
    if clear_axis > 0:
        xs = np.arange(half_w)[None, :]
        fil = np.where(xs < clear_axis, 0.0, fil)
        fil = np.where(np.abs(my[:, None]) * height < clear_axis, 0.0, fil)
    return fil.astype(np.float32)


def fourier_filter(img: torch.Tensor, lp: float, hp: float, lps: float, hps: float,
                   clear_axis: int = 0) -> torch.Tensor:
    """Apply the radial fourier filter to a real image (..., H, W) via
    rfft2."""
    h, w = img.shape[-2], img.shape[-1]
    mask = _const_array(fourier_filter_mask, (h, w, lp, hp, lps, hps, clear_axis), img.device)
    return torch.fft.irfft2(torch.fft.rfft2(img) * mask, s=(h, w))
