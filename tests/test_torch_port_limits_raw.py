"""The RAW path with 109 merge taps and on a non-Bayer pattern, each a
general-kernel merge on the card (csrc/merge_raw.cu), against the jitted
JAX pipeline at the smallest shape the configurations take
(tests/test_torch_port_limits.py has the rest of the port's former
limits)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from torch_parity import nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres_raw as jax_handheld_superres_raw,
)
from multi_frame_super_resolution_tpu_torch.config import RAW_PORT_DEFAULT, MergeConfig
from multi_frame_super_resolution_tpu_torch.data import synthetic_raw_burst
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres_raw


def test_raw_109_taps_matches_jax_pipeline():
    """MergeConfig(radius=5, prune_exp=40): 109 taps to +-5 at the path's
    k_max (11 x 11 less the corners e^-40 prunes), past the templated
    merge's +-4 and its 81, on a 4-frame 64 x 128 RAW burst against the
    jitted JAX pipeline: 60 dB. Measured 110.1 dB."""
    cfg = dataclasses.replace(RAW_PORT_DEFAULT, merge=MergeConfig(radius=5, prune_exp=40.0))
    burst = synthetic_raw_burst(np.random.default_rng(0), 4, 64, 128, 2.5)[0]
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(burst), to_jax(cfg)))
    got = nn(handheld_superres_raw(tt(burst), cfg, device="cpu"))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0


def test_raw_non_bayer_matches_jax_pipeline():
    """cfa_pattern=((0, 1), (2, 1)): green in one column, which the
    templated merge's pair grouping does not take, on a 4-frame 64 x 128
    RAW burst against the jitted JAX pipeline: 60 dB. Measured 105.8
    dB."""
    cfg = dataclasses.replace(RAW_PORT_DEFAULT, cfa_pattern=((0, 1), (2, 1)))
    burst = synthetic_raw_burst(np.random.default_rng(0), 4, 64, 128, 2.5)[0]
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(burst), to_jax(cfg)))
    got = nn(handheld_superres_raw(tt(burst), cfg, device="cpu"))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0
