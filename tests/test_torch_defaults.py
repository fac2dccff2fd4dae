"""Both handheld entry points called without a configuration: the port's
defaults are the JAX package's, HandheldConfig() for handheld_superres
and HandheldConfig(gamma=True) for handheld_superres_raw, and each
matches the jitted JAX function called the same way."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import nn, psnr, tt

from multi_frame_super_resolution_tpu.models import handheld as jax_handheld
from multi_frame_super_resolution_tpu_torch.config import HandheldConfig
from multi_frame_super_resolution_tpu_torch.data import synthetic_raw_burst, synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.models.handheld import (
    handheld_superres,
    handheld_superres_raw,
)


def test_default_configs_are_the_jax_defaults():
    for fn, want in ((handheld_superres, HandheldConfig()), (handheld_superres_raw, HandheldConfig(gamma=True))):
        assert inspect.signature(fn).parameters["cfg"].default == want


def test_rgb_entry_point_default_matches_jax():
    """F = 4 at 64 x 128, unrotated: the default pre-alignment estimates
    and applies small similarities, the default merge branch runs with
    its gated restore."""
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    want = nn(jax.jit(jax_handheld.handheld_superres)(jnp.asarray(burst)))
    got = nn(handheld_superres(tt(burst), device="cpu"))
    assert got.shape == (128, 256, 3)
    assert psnr(got, want) >= 60.0


def test_raw_entry_point_default_matches_jax():
    """F = 4 at 128 x 256 RAW: pre-alignment, three pyramid levels of
    T = 16, the order-1 merge at scale 2, restore and sRGB gamma."""
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 128, 256, 2.5)
    want = nn(jax.jit(jax_handheld.handheld_superres_raw)(jnp.asarray(raw)))
    got = nn(handheld_superres_raw(tt(raw), device="cpu"))
    assert got.shape == (256, 512, 3)
    assert psnr(got, want) >= 60.0
