"""Synthetic bursts in numpy alone.

The counterpart of ``multi_frame_super_resolution_tpu.data.datasets``'s
``synthetic_burst``, ``_rotate_translate_crop`` and ``mosaic_rggb``
(datasets.py:54-150), which produce the same arrays from the same
generator state. That module
is not imported: its package pulls in Pillow (data/io.py), which the
port does not need. Everything here is numpy, made from a seeded
``np.random.Generator``, so the JAX reference and the port receive
identical inputs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from multi_frame_super_resolution_tpu_torch.data.io import imread

# the tracked high-resolution scene of the true-HR bursts (512 x 1024 x 3)
CITY_HR_SCENE = Path(__file__).resolve().parents[2] / "city_handheld_sr.png"


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


# the city burst's per-frame rotations, 0/0/5/10/-15 degrees
CITY_ANGLES = tuple(float(np.deg2rad(d)) for d in (0.0, 0.0, 5.0, 10.0, -15.0))


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
    angles: Sequence[float] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Subpixel-shifted (and optionally rotated) crops of one scene.

    ``angles`` (radians, one per frame) replaces the rotations drawn from
    +-``max_rotation``; the generator is drawn from as without it, so the
    shifts stay the same. Returns ``(burst (F, H, W[, C]), true_shifts
    (F, 2) as (dy, dx))``; frame 0 is the unshifted reference.
    """
    if angles is not None and len(angles) != num_frames:
        raise ValueError(f"angles needs {num_frames} entries, got {len(angles)}")
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
        if angles is not None:
            ang = float(angles[f])
        shifts[f] = (dy, dx)
        frames.append(_rotate_translate_crop(base, dy, dx, ang, height, width))
    return np.stack(frames, axis=0).astype(np.float32), shifts


def synthetic_rgb_burst(
    rng: np.random.Generator,
    num_frames: int = 5,
    height: int = 256,
    width: int = 512,
    max_shift: float = 3.0,
    angles: Sequence[float] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """RGB burst (F, H, W, 3) in [0, 1]: three independent broadband planes
    drawn from ``rng``, moved together by one set of frame shifts and,
    given ``angles``, rotations (see ``synthetic_burst``). The defaults are the city burst's
    geometry (5 x 256 x 512 x 3); ``CITY_ANGLES`` are its rotations."""
    pad = int(np.ceil(max_shift)) + 8
    base = np.stack(
        [_broadband_plane(rng, height + 2 * pad, width + 2 * pad) for _ in range(3)],
        axis=-1,
    )
    return synthetic_burst(rng, num_frames, height, width, max_shift, base=base, angles=angles)


def mosaic_rggb(
    rgb: np.ndarray, cfa: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 1), (1, 2))
) -> np.ndarray:
    """RGB image (H, W, 3) -> Bayer mosaic (H, W) under the 2x2 CFA
    pattern (0=R, 1=G, 2=B)."""
    h, w = rgb.shape[:2]
    out = np.empty((h, w), rgb.dtype)
    for dy in range(2):
        for dx in range(2):
            out[dy::2, dx::2] = rgb[dy::2, dx::2, cfa[dy][dx]]
    return out


def synthetic_raw_burst(
    rng: np.random.Generator,
    num_frames: int = 5,
    height: int = 256,
    width: int = 512,
    max_shift: float = 3.0,
    cfa: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 1), (1, 2)),
    angles: Sequence[float] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bayer RAW burst (F, H, W) in [0, 1]: every frame of
    ``synthetic_rgb_burst`` mosaicked under ``cfa``. The defaults are the
    city burst's geometry, the input bench.py times."""
    rgb, shifts = synthetic_rgb_burst(rng, num_frames, height, width, max_shift, angles)
    return np.stack([mosaic_rggb(frame, cfa) for frame in rgb]), shifts


def _downsample2(img: np.ndarray) -> np.ndarray:
    """2 x 2 box mean of an (H, W, C) image (the odd last row and column
    dropped)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    return img[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))


def true_hr_burst(
    hr: np.ndarray | None = None,
    num_frames: int = 5,
    seed: int = 7,
    max_shift_hr: float = 3.0,
    max_rot: float = 0.01,
    factor: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """A RAW burst made from a known high-resolution scene, the recipe of
    the JAX package's true-HR protocol (tools/eval_fidelity.py::
    make_hr_burst): frame 0 unmoved, every other frame shifted by up to
    ``max_shift_hr`` HR pixels and rotated by up to ``max_rot`` radians
    (``_rotate_translate_crop``, drawn from ``seed``), box-downsampled by
    ``factor`` (a power of 2) and RGGB-mosaicked. ``hr`` (H, W, 3) in
    [0, 1] defaults to the tracked city scene (CITY_HR_SCENE), which
    gives a 5 x 256 x 512 burst. Returns (raw (F, H/factor, W/factor)
    float32, hr): the output of a factor-x super-resolution is compared
    with ``hr`` itself."""
    if hr is None:
        hr = imread(CITY_HR_SCENE)
    h, w = hr.shape[:2]
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(num_frames):
        if f == 0:
            dy = dx = ang = 0.0
        else:
            dy, dx = rng.uniform(-max_shift_hr, max_shift_hr, 2)
            ang = rng.uniform(-max_rot, max_rot)
        lr = np.stack([_rotate_translate_crop(hr[..., c], dy, dx, ang, h, w) for c in range(3)], axis=-1)
        lr = lr.astype(np.float32)
        fct = factor
        while fct > 1:
            lr = _downsample2(lr)
            fct //= 2
        frames.append(mosaic_rggb(lr))
    return np.stack(frames).astype(np.float32), hr


def synthetic_polar_pair(
    rng: np.random.Generator, height: int = 300, width: int = 400
) -> Tuple[np.ndarray, np.ndarray]:
    """(Iper, Ipar), each (H, W, 3) float32 in [0, 1]: the polarization-
    defog app's synthetic fog (a random scene under a vertical haze ramp,
    apps/polar_defog.py, inputType 3) at any size. At the defaults and
    ``np.random.default_rng(0)`` it is the app's own input."""
    base = rng.random((height, width, 3)).astype(np.float32) * 0.5
    haze = np.linspace(0.2, 0.7, height, dtype=np.float32)[:, None, None]
    iper = np.clip(base * 0.5 + haze * 0.8, 0, 1)
    ipar = np.clip(base * 0.5 + haze * 0.3, 0, 1)
    return iper, ipar


def synthetic_dataset_burst(name: str, seed: int = 0) -> np.ndarray:
    """A synthetic RGB burst (F, H, W, 3) at the geometry of the reference
    burst ``name``, shifted by up to 3 px; the city burst is also rotated
    0/0/5/10/-15 degrees, as the real one is (``CITY_ANGLES``)."""
    from multi_frame_super_resolution_tpu_torch.data.datasets import DATASETS, FRAME_SIZE

    f, (h, w) = DATASETS[name][1], FRAME_SIZE[name]
    angles = CITY_ANGLES if name == "city" else None
    return synthetic_rgb_burst(np.random.default_rng(seed), f, h, w, 3.0, angles=angles)[0]

