"""The RGB default branch at scale 5, a general-kernel merge on the card
(csrc/merge.cu), against the jitted JAX pipeline at the smallest shape
the configuration takes (tests/test_torch_port_limits.py has the rest of
the port's former limits)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres as jax_handheld_superres,
)
from multi_frame_super_resolution_tpu_torch.config import RGB_DEFAULT_NOPRE
from multi_frame_super_resolution_tpu_torch.data import synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres


def test_rgb_scale5_matches_jax_pipeline():
    """RGB_DEFAULT without pre-alignment at scale 5 on a 4-frame 64 x 128
    burst against the jitted JAX pipeline: 60 dB. Measured 119.8 dB."""
    cfg = dataclasses.replace(RGB_DEFAULT_NOPRE, scale=5)
    burst = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)[0]
    want = nn(jax.jit(jax_handheld_superres, static_argnums=1)(jnp.asarray(burst), to_jax(cfg)))
    got = nn(handheld_superres(tt(burst), cfg, device="cpu"))
    assert got.shape == (320, 640, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0
