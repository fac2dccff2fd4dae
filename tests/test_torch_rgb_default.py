"""The default RGB merge branch end to end (merge.use_pallas=False, the
JAX package's default): handheld_superres at config.RGB_DEFAULT_NOPRE,
at config.RGB_DEFAULT on a burst rotated as the city burst is, at scale
4 and with merge.rgb_order=1, against the jitted JAX pipeline (which
reaches no Pallas kernel on this branch)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres as jax_handheld_superres,
)
from multi_frame_super_resolution_tpu_torch.config import (
    RGB_DEFAULT,
    RGB_DEFAULT_NOPRE,
    HandheldConfig,
    MergeConfig,
    check_supported,
)
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models import handheld
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres


def _jax_run(burst, cfg):
    return nn(jax.jit(jax_handheld_superres, static_argnums=1)(jnp.asarray(burst), to_jax(cfg)))


def test_named_configs_are_the_jax_defaults():
    assert RGB_DEFAULT == HandheldConfig() and not RGB_DEFAULT.merge.use_pallas
    assert RGB_DEFAULT_NOPRE == HandheldConfig(prealign=False)
    for cfg in (RGB_DEFAULT, RGB_DEFAULT_NOPRE):
        check_supported(cfg)
        check_supported(dataclasses.replace(cfg, merge=MergeConfig(rgb_order=1)))
        check_supported(dataclasses.replace(cfg, scale=4))


@pytest.mark.parametrize(
    "cfg,scale",
    [
        (RGB_DEFAULT_NOPRE, 2),
        (dataclasses.replace(RGB_DEFAULT_NOPRE, merge=MergeConfig(rgb_order=1)), 2),
        (dataclasses.replace(RGB_DEFAULT_NOPRE, scale=4), 4),
    ],
    ids=["order0", "order1", "scale4"],
)
def test_default_branch_matches_jax_pipeline(cfg, scale):
    """F = 4 at 64 x 128, motion up to 2.5 px, no pre-alignment: order 0
    (phase-layout merge, gated restore), the plugin order-1 solve on the
    merge's moments, and scale 4 (no restore). Measured 121.5, 121.9 and
    119.7 dB; 60 dB leaves room for a rare argmin or bf16 window-sum step
    landing the other way, as for the use_pallas slice."""
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    want = _jax_run(burst, cfg)
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst), cfg, device="cpu"))
    assert got.shape == (64 * scale, 128 * scale, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert not LAUNCHES  # CPU tensors take the plain versions
    assert psnr(got, want) >= 60.0


def test_rgb_default_matches_jax_pipeline():
    """RGB_DEFAULT (pre-alignment on) on F = 5 at 64 x 128, frames
    rotated 0/0/5/10/-15 degrees: the port estimates the similarities
    itself, as in the RGB_PALLAS test."""
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 5, 64, 128, 2.5, angles=CITY_ANGLES)
    want = _jax_run(burst, RGB_DEFAULT)
    got = nn(handheld_superres(tt(burst), RGB_DEFAULT, device="cpu"))
    assert got.shape == (128, 256, 3)
    assert psnr(got, want) >= 60.0


def test_default_branch_runs_the_gated_restore(monkeypatch):
    """At scale 2 the default branch gates the restore on the registered
    half-res luma and residual (the use_pallas branch has no restore);
    at scale 4 it skips it, as the JAX function does."""
    seen = []
    stat_fn = handheld.temporal_noise_stat

    def recording_stat(gray, residual):
        seen.append((tuple(gray.shape), tuple(residual.shape)))
        return stat_fn(gray, residual=residual)

    monkeypatch.setattr(handheld, "temporal_noise_stat", recording_stat)
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    handheld_superres(tt(burst), RGB_DEFAULT_NOPRE, device="cpu")
    assert seen == [((4, 32, 64), (3, 32, 64, 2))]
    handheld_superres(tt(burst), dataclasses.replace(RGB_DEFAULT_NOPRE, scale=4), device="cpu")
    assert len(seen) == 1
