"""Synthetic bursts in numpy alone.

The counterpart of ``multi_frame_super_resolution_tpu.data.datasets``'s
``synthetic_burst`` and ``_rotate_translate_crop`` (datasets.py:54-135),
which produce the same arrays from the same generator state. That module
is not imported: its package pulls in Pillow (data/io.py), which the
port does not need. Everything here is numpy, made from a seeded
``np.random.Generator``, so the JAX reference and the port receive
identical inputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rotate_translate_crop(
    img: np.ndarray, dy: float, dx: float, angle: float, out_h: int, out_w: int
) -> np.ndarray:
    """Bilinear crop of ``img`` rotated by ``angle`` (radians) about the
    image center and shifted by (dy, dx)."""
    h, w = img.shape[:2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.meshgrid(
        np.arange(out_h, dtype=np.float32) - (out_h - 1) / 2.0,
        np.arange(out_w, dtype=np.float32) - (out_w - 1) / 2.0,
        indexing="ij",
    )
    ca, sa = np.cos(angle), np.sin(angle)
    src_y = cy + sa * xx + ca * yy + dy
    src_x = cx + ca * xx - sa * yy + dx
    y0 = np.clip(np.floor(src_y).astype(np.int32), 0, h - 2)
    x0 = np.clip(np.floor(src_x).astype(np.int32), 0, w - 2)
    fy = np.clip(src_y - y0, 0.0, 1.0)[..., None]
    fx = np.clip(src_x - x0, 0.0, 1.0)[..., None]
    if img.ndim == 2:
        img = img[..., None]
    p00 = img[y0, x0]
    p01 = img[y0, x0 + 1]
    p10 = img[y0 + 1, x0]
    p11 = img[y0 + 1, x0 + 1]
    out = (
        p00 * (1 - fy) * (1 - fx)
        + p01 * (1 - fy) * fx
        + p10 * fy * (1 - fx)
        + p11 * fy * fx
    )
    return out.squeeze(-1) if out.shape[-1] == 1 else out


def _broadband_plane(rng: np.random.Generator, bh: int, bw: int) -> np.ndarray:
    """Multi-octave noise scene in [0, 1]: coarse structure for the search
    range, fine texture so subpixel estimation is well-posed, blurred
    lightly for subpixel interpolability."""
    base = np.zeros((bh, bw), np.float32)
    for octave, amp in [(16, 1.0), (8, 0.6), (4, 0.35), (2, 0.2), (1, 0.1)]:
        noise = rng.standard_normal((bh // octave + 2, bw // octave + 2)).astype(
            np.float32
        )
        up = np.kron(noise, np.ones((octave, octave), np.float32))
        base += amp * up[:bh, :bw]
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(2):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, base)
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    return (base - base.min()) / (base.max() - base.min() + 1e-8)


def synthetic_burst(
    rng: np.random.Generator,
    num_frames: int = 5,
    height: int = 128,
    width: int = 256,
    max_shift: float = 3.0,
    max_rotation: float = 0.0,
    base: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Subpixel-shifted (and optionally rotated) crops of one scene.

    Returns ``(burst (F, H, W[, C]), true_shifts (F, 2) as (dy, dx))``;
    frame 0 is the unshifted reference.
    """
    pad = int(np.ceil(max_shift)) + 8
    if base is None:
        base = _broadband_plane(rng, height + 2 * pad, width + 2 * pad)
    frames = []
    shifts = np.zeros((num_frames, 2), np.float32)
    for f in range(num_frames):
        if f == 0:
            dy = dx = 0.0
            ang = 0.0
        else:
            dy, dx = rng.uniform(-max_shift, max_shift, size=2)
            ang = rng.uniform(-max_rotation, max_rotation)
        shifts[f] = (dy, dx)
        frames.append(_rotate_translate_crop(base, dy, dx, ang, height, width))
    return np.stack(frames, axis=0).astype(np.float32), shifts


def synthetic_rgb_burst(
    rng: np.random.Generator,
    num_frames: int = 5,
    height: int = 256,
    width: int = 512,
    max_shift: float = 3.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """RGB burst (F, H, W, 3) in [0, 1]: three independent broadband planes
    drawn from ``rng``, moved together by one set of frame shifts. The
    defaults are the city burst's geometry (5 x 256 x 512 x 3)."""
    pad = int(np.ceil(max_shift)) + 8
    base = np.stack(
        [_broadband_plane(rng, height + 2 * pad, width + 2 * pad) for _ in range(3)],
        axis=-1,
    )
    return synthetic_burst(rng, num_frames, height, width, max_shift, base=base)
