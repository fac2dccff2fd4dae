"""The RAW path at scale 5 and the RGB default branch at tap radius 9,
each a general-kernel merge on the card (csrc/merge_raw.cu,
csrc/merge.cu), against the jitted JAX pipelines at the smallest shape
the configurations take (tests/test_torch_port_limits.py has the rest of
the port's former limits)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres_raw as jax_handheld_superres_raw,
)
from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres as jax_handheld_superres,
)
from multi_frame_super_resolution_tpu_torch.config import RAW_PORT_DEFAULT, RGB_DEFAULT_NOPRE, MergeConfig
from multi_frame_super_resolution_tpu_torch.data import synthetic_raw_burst, synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres, handheld_superres_raw


def test_raw_scale5_matches_jax_pipeline():
    """RAW_PORT_DEFAULT at scale 5 on a 4-frame 64 x 128 RAW burst
    (synthetic_raw_burst: on uniform noise LK's bfloat16 window sums put
    it at 61 dB) against the jitted JAX pipeline: 60 dB. Measured 101.1
    dB."""
    cfg = dataclasses.replace(RAW_PORT_DEFAULT, scale=5)
    burst = synthetic_raw_burst(np.random.default_rng(0), 4, 64, 128, 2.5)[0]
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(burst), to_jax(cfg)))
    got = nn(handheld_superres_raw(tt(burst), cfg, device="cpu"))
    assert got.shape == (320, 640, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0


def test_rgb_tap_radius9_matches_jax_pipeline():
    """The RGB default branch with MergeConfig(radius=8): tap radius 9,
    past the templated merge's 8, on a 4-frame 64 x 128 burst against the
    jitted JAX pipeline: 60 dB. Measured 121.5 dB."""
    cfg = dataclasses.replace(RGB_DEFAULT_NOPRE, merge=MergeConfig(radius=8))
    burst = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)[0]
    want = nn(jax.jit(jax_handheld_superres, static_argnums=1)(jnp.asarray(burst), to_jax(cfg)))
    got = nn(handheld_superres(tt(burst), cfg, device="cpu"))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0
