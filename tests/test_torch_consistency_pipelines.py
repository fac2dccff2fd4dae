"""The alignment knobs end to end against the jitted JAX pipelines:
config.RAW_CONSISTENT and config.RGB_CONSISTENT (the shift-consistency
solve over pairs of frames), config.RAW_FFT (FFT SSD surfaces), and both
gather oracles with use_consistency, each on a burst rotated as the city
burst is."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import handheld_superres as jax_handheld_superres
from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres_raw as jax_handheld_superres_raw,
)
from multi_frame_super_resolution_tpu.registration import align as jalign
from multi_frame_super_resolution_tpu_torch.config import (
    RAW_CONSISTENT,
    RAW_FFT,
    RAW_ORACLE,
    RGB_CONSISTENT,
    RGB_ORACLE,
)
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_raw_burst, synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres, handheld_superres_raw
from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray
from multi_frame_super_resolution_tpu_torch.ops.geometry import downsample2_planes
from multi_frame_super_resolution_tpu_torch.registration import align
from multi_frame_super_resolution_tpu_torch.registration.prealign import prealign_burst


def _raw():
    """F = 5 at 128 x 256 RAW (64 x 128 half-res), rotated 0/0/5/10/-15 degrees."""
    return synthetic_raw_burst(np.random.default_rng(0), 5, 128, 256, 2.5, angles=CITY_ANGLES)[0]


def _rgb(h, w):
    return synthetic_rgb_burst(np.random.default_rng(0), 5, h, w, 2.5, angles=CITY_ANGLES)[0]


@pytest.mark.parametrize(
    "entry,cfg",
    [
        ("raw", RAW_CONSISTENT),
        ("raw", RAW_FFT),
        ("raw", dataclasses.replace(RAW_ORACLE, use_consistency=True)),
        ("rgb", RGB_CONSISTENT),
        ("rgb", dataclasses.replace(RGB_ORACLE, use_consistency=True)),
    ],
    ids=["raw-consistent", "raw-fft", "raw-oracle-consistent", "rgb-consistent", "rgb-oracle-consistent"],
)
def test_alignment_knob_matches_jax_pipeline(entry, cfg):
    """Pre-alignment on. RAW at 128 x 256, RGB at 128 x 256 (a 4 x 8 tile
    grid at the half-res alignment; at 64 x 128 see the next test).
    Measured: RAW_CONSISTENT 87.9 dB, RAW_FFT 103.5, the RAW oracle 86.6,
    RGB_CONSISTENT 96.2, the RGB oracle (64 x 128) 78.5. 60 dB as for the
    slice. The FFT branch launches no tile search (the JAX function there
    is the FFT surface), and on the CPU nothing launches at all."""
    if entry == "raw":
        x, jax_fn, fn = _raw(), jax_handheld_superres_raw, handheld_superres_raw
    else:
        x = _rgb(*((64, 128) if not cfg.fast else (128, 256)))
        jax_fn, fn = jax_handheld_superres, handheld_superres
    want = nn(jax.jit(jax_fn, static_argnums=1)(jnp.asarray(x), to_jax(cfg)))
    LAUNCHES.clear()
    got = nn(fn(tt(x), cfg, device="cpu"))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert not LAUNCHES
    assert psnr(got, want) >= 60.0


def test_rgb_consistent_alignment_on_a_small_burst_matches_jax():
    """At 64 x 128 (a 2 x 4 tile grid at half res, 1 x 1 at the third
    level) RGB_CONSISTENT's pipelines part: one top-row tile's consistent
    shift moves by 2.9 px in the JAX function itself when its input moves
    by 3e-5 (the port's pre-aligned luma against JAX's), while every pair
    measurement moves by 3.4e-4 px at most: the outlier rejection's
    decision there is float32 rounding's. On one input, the port's
    pre-aligned half-res luma, the two consistent alignments agree within
    1e-3 px."""
    rgb = tt(_rgb(64, 128))
    burst, _ = prealign_burst(rgb, rgb_to_gray(rgb), RGB_CONSISTENT.prealign_cfg)
    gray = downsample2_planes(rgb_to_gray(burst))
    got = nn(align.align_burst_consistent(gray, RGB_CONSISTENT.align))
    want = np.asarray(jax.jit(lambda g: jalign.align_burst_consistent(g, to_jax(RGB_CONSISTENT.align)))(
        jnp.asarray(nn(gray))))
    assert got.shape == (5, 2, 4, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
