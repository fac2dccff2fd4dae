"""FFT log-polar rotation / scale / translation registration (counterpart
of registration/logpolar.py). ``register_translation``,
``register_rotation_scale`` and ``register_similarity`` take the JAX
call form, two (H, W) images; their ``_batched`` forms take the moving
frames (B, H, W) at once, as the pre-alignment does:

  gray -> apodize -> FFT -> fftshift -> high-pass x magnitude ->
  log-polar remap -> phase-correlate the log-polar magnitudes ->
  (rotation, scale) -> unrotate / unscale -> phase-correlate ->
  translation.

The log-polar remap is the gather ``remap`` for both values of
``RegistrationConfig.lp_matmul``: the JAX package's matmul form computes
the same resample with the same clamped borders through static
separable weights, a layout for the TPU's matrix unit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from port_bench.reference.config import RegistrationConfig
from port_bench.reference.ops.filters import _const_array
from port_bench.reference.ops.fourier import apodization_window, high_pass_filter
from port_bench.reference.ops.geometry import remap_planes
from port_bench.reference.ops.warp_fast import similarity_warp_fast
from port_bench.reference.registration.phase_correlation import (
    _check_pair,
    phase_correlate_batched,
)


def log_polar_params(rows: int, cols: int) -> Tuple[int, float]:
    """(map size, log base) of the reference's log-polar maps."""
    size = max(rows, cols)
    log_base = math.exp(math.log(rows * 1.1 / 2.0) / size)
    return size, log_base


def log_polar_maps(rows: int, cols: int, radius_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(ymap, xmap) of shape (size, ceil(size / radius_step)): row i is
    angle -i pi / (size - 1), column j radius logBase^(j radius_step),
    about the image center, the radius laid out in isotropic normalized
    frequency (x stretched by cols / rows), as the JAX package lays it."""
    size, log_base = log_polar_params(rows, cols)
    scales = np.power(log_base, np.arange(0, size, radius_step, dtype=np.float64))
    angles = -np.arange(size, dtype=np.float64) * (np.pi / (size - 1))
    xmap = (scales[None, :] * (cols / rows)) * np.cos(angles)[:, None] + cols / 2.0
    ymap = scales[None, :] * np.sin(angles)[:, None] + rows / 2.0
    return ymap.astype(np.float32), xmap.astype(np.float32)


def _log_polar_map(rows: int, cols: int, radius_step: int, axis: int) -> np.ndarray:
    return log_polar_maps(rows, cols, radius_step)[axis]


def to_log_polar(img: torch.Tensor, method: str = "bicubic", radius_step: int = 1) -> torch.Tensor:
    """Log-polar resample of planes (..., rows, cols)."""
    rows, cols = img.shape[-2], img.shape[-1]
    ymap = _const_array(_log_polar_map, (rows, cols, int(radius_step), 0), img.device)
    xmap = _const_array(_log_polar_map, (rows, cols, int(radius_step), 1), img.device)
    return remap_planes(img, ymap, xmap, method)


def _spectral_magnitude(img: torch.Tensor, window: torch.Tensor, hp: torch.Tensor) -> torch.Tensor:
    """Apodize, FFT, fftshift, high-pass-weighted magnitude."""
    f = torch.fft.fftshift(torch.fft.fft2(img * window), dim=(-2, -1))
    return hp * torch.abs(f)


@dataclasses.dataclass
class SimilarityTransform:
    """A similarity: rotation (radians), scale (isotropic), translation
    (dy, dx) and response (the final phase-correlation peak), as 0-d
    tensors and a (2,) translation from ``register_similarity``, each
    with a leading frame axis from ``register_similarity_batched``."""

    rotation: torch.Tensor
    scale: torch.Tensor
    translation: torch.Tensor
    response: torch.Tensor


def similarity_from_numpy(st, device=None) -> SimilarityTransform:
    """A SimilarityTransform of the JAX package (or any object with the
    four fields, as arrays with a leading frame axis) -> the port's, as
    float32 tensors on ``device``: the estimate carried from one
    implementation to the other."""

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return SimilarityTransform(
        rotation=t(st.rotation), scale=t(st.scale),
        translation=t(st.translation), response=t(st.response),
    )


def _window(rows: int, cols: int, cfg: RegistrationConfig, device) -> torch.Tensor:
    radius = int(cfg.apodization_ratio * min(rows, cols))
    return _const_array(apodization_window, (rows, cols, radius), device)


def register_rotation_scale_batched(
    im0: torch.Tensor, im1: torch.Tensor, cfg: RegistrationConfig = RegistrationConfig()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rotation, scale, response), each (B,), such that each frame of im1
    (B, H, W) is im0 (H, W) rotated by ``rotation`` about the center and
    scaled by ``scale``."""
    rows, cols = im0.shape[-2], im0.shape[-1]
    size, log_base = log_polar_params(rows, cols)
    win = _window(rows, cols, cfg, im0.device)
    hp = _const_array(high_pass_filter, (rows, cols), im0.device)
    step = max(int(cfg.lp_radius_step), 1)
    lp0 = to_log_polar(_spectral_magnitude(im0, win, hp), cfg.logpolar_interp, step)
    lp1 = to_log_polar(_spectral_magnitude(im1, win, hp), cfg.logpolar_interp, step)
    shift, peak = phase_correlate_batched(lp0, lp1, cfg.eps, cfg.subpixel, refine=cfg.peak_upsample)
    # row shift <-> rotation (angle step pi / (size - 1), negative
    # direction); column shift <-> log-radius (step log-base steps) <-> scale
    rotation = shift[:, 0] * (math.pi / (size - 1))
    scale = torch.pow(log_base, -shift[:, 1] * step)
    return rotation, scale, peak


def register_rotation_scale(
    im0: torch.Tensor, im1: torch.Tensor, cfg: RegistrationConfig = RegistrationConfig()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rotation, scale, response), 0-d tensors, such that im1 (H, W) is
    im0 (H, W) rotated by ``rotation`` about the center and scaled by
    ``scale``."""
    _check_pair(im0, im1, "register_rotation_scale")
    rotation, scale, peak = register_rotation_scale_batched(im0, im1[None], cfg)
    return rotation[0], scale[0], peak[0]


def register_translation_batched(
    im0: torch.Tensor, im1: torch.Tensor, cfg: RegistrationConfig = RegistrationConfig()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dx) (B, 2) such that each frame of im1 (B, H, W) satisfies
    im1(x) ~= im0(x + d): apodized global phase correlation."""
    rows, cols = im0.shape[-2], im0.shape[-1]
    win = _window(rows, cols, cfg, im0.device)
    return phase_correlate_batched(im0, im1, cfg.eps, cfg.subpixel, window=win, refine=cfg.peak_upsample)


def register_translation(
    im0: torch.Tensor, im1: torch.Tensor, cfg: RegistrationConfig = RegistrationConfig()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dy, dx) (2,) such that im1(x) ~= im0(x + d), and the peak
    response, of two (H, W) images."""
    _check_pair(im0, im1, "register_translation")
    shift, peak = register_translation_batched(im0, im1[None], cfg)
    return shift[0], peak[0]


def register_similarity_batched(
    im0: torch.Tensor, im1: torch.Tensor, cfg: RegistrationConfig = RegistrationConfig()
) -> SimilarityTransform:
    """Rotation, scale and translation of each frame of im1 (B, H, W)
    against im0 (H, W): the log-polar stage, then im1 unrotated and
    unscaled, then the residual translation."""
    rotation, scale, _ = register_rotation_scale_batched(im0, im1, cfg)
    h, w = im1.shape[-2], im1.shape[-1]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = im1.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    ca = torch.cos(rotation)[:, None, None]
    sa = torch.sin(rotation)[:, None, None]
    sc = scale[:, None, None]
    src_y = (sa * xs + ca * ys) * sc + cy
    src_x = (ca * xs - sa * ys) * sc + cx
    if cfg.fast_warp:
        unrotated = similarity_warp_fast(im1, src_y, src_x)
    else:
        unrotated = remap_planes(im1, src_y, src_x, "bicubic")
    shift, peak = register_translation_batched(im0, unrotated, cfg)
    return SimilarityTransform(rotation=rotation, scale=scale, translation=shift, response=peak)


def register_similarity(
    im0: torch.Tensor, im1: torch.Tensor, cfg: RegistrationConfig = RegistrationConfig()
) -> SimilarityTransform:
    """Rotation, scale and translation of im1 (H, W) against im0 (H, W),
    each field of the result 0-d (the translation (2,))."""
    _check_pair(im0, im1, "register_similarity")
    st = register_similarity_batched(im0, im1[None], cfg)
    return SimilarityTransform(
        rotation=st.rotation[0], scale=st.scale[0], translation=st.translation[0], response=st.response[0]
    )
