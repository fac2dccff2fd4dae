"""The RAW path at scales 3 and 4 and the scale-4 cascade
(handheld_superres_raw_cascade), against the jitted JAX pipeline, on
true-HR bursts made from the tracked city_handheld_sr.png
(torch_parity.city_hr_raw_burst); config.RAW_SCALE4, the JAX package's
own scale-4 configuration."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import city_hr_raw_burst, nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres_raw as jax_handheld_superres_raw,
)
from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres_raw_cascade as jax_cascade,
)
from multi_frame_super_resolution_tpu_torch.config import (
    RAW_SCALE4,
    AlignConfig,
    HandheldConfig,
    MergeConfig,
    check_supported_raw,
)
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models import handheld
from multi_frame_super_resolution_tpu_torch.models.handheld import (
    handheld_superres_raw,
    handheld_superres_raw_cascade,
)

NOPRE = dataclasses.replace(RAW_SCALE4, prealign=False)


def test_raw_scale4_is_the_jax_configuration():
    """Letter for letter the configuration of the JAX package's scale-4
    fidelity and cascade tests."""
    assert RAW_SCALE4 == HandheldConfig(
        align=AlignConfig(tile_size=8, search_radius=4, levels=2),
        gamma=False, scale=4, merge=MergeConfig(k_min_rb=0.5),
    )
    for scale in (1, 2, 3, 4):
        check_supported_raw(dataclasses.replace(RAW_SCALE4, scale=scale))


@pytest.mark.parametrize("frames,scale", [(5, 3), (9, 4)], ids=["scale3", "scale4"])
def test_raw_scales_match_jax_pipeline(frames, scale):
    """RAW_SCALE4 without pre-alignment at scale 3 (5 frames) and 4 (9
    frames, the configuration's burst), 64 x 128 RAW made at factor 4.
    Measured 110 and 109 dB on a synthetic burst; 60 dB as for the
    scale-2 slice."""
    raw = city_hr_raw_burst(frames, 4, 256, 512)
    cfg = dataclasses.replace(NOPRE, scale=scale)
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(cfg)))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    assert got.shape == (64 * scale, 128 * scale, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert not LAUNCHES
    assert psnr(got, want) >= 60.0


def test_cascade_matches_jax_pipeline():
    """The cascade at RAW_SCALE4 without pre-alignment on 5 frames: the
    scale-2 run, its 2x bicubic upscale as the scale-4 run's fallback,
    the threshold raised to 1.0. Measured 93 dB on a synthetic burst."""
    raw = city_hr_raw_burst(5, 4, 256, 512)
    want = nn(jax.jit(jax_cascade, static_argnums=1)(jnp.asarray(raw), to_jax(NOPRE)))
    got = nn(handheld_superres_raw_cascade(tt(raw), NOPRE, device="cpu"))
    assert got.shape == (256, 512, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0


def test_cascade_runs_both_scales_with_the_upscaled_fallback(monkeypatch):
    """The cascade is two entry-point calls: scale 2 with gamma off, then
    scale 4 with the threshold at least 1.0 and the scale-2 output
    upscaled 2x bicubic as fallback_hr; it takes scale 4 only."""
    calls = []
    entry = handheld.handheld_superres_raw

    def recording(raw_burst, cfg, prealign_override=None, fallback_hr=None, *, device=None):
        calls.append((cfg, None if fallback_hr is None else tuple(fallback_hr.shape)))
        return entry(raw_burst, cfg, prealign_override, fallback_hr, device=device)

    monkeypatch.setattr(handheld, "handheld_superres_raw", recording)
    raw = tt(city_hr_raw_burst(3, 4, 128, 256))
    handheld_superres_raw_cascade(raw, dataclasses.replace(NOPRE, gamma=True), device="cpu")
    (cfg2, fb2), (cfg4, fb4) = calls
    assert cfg2.scale == 2 and not cfg2.gamma and fb2 is None
    assert cfg4.scale == 4 and cfg4.gamma and cfg4.merge.weight_threshold == 1.0 and fb4 == (128, 256, 3)
    with pytest.raises(ValueError, match="scale 4"):
        handheld_superres_raw_cascade(raw, dataclasses.replace(NOPRE, scale=2), device="cpu")


def test_fallback_hr_shape_is_checked():
    raw = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match="fallback_hr"):
        handheld_superres_raw(raw, NOPRE, fallback_hr=torch.zeros((32, 32, 3)), device="cpu")
