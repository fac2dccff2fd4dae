"""The RAW gather oracle (handheld_superres_raw with fast=False) against
the jitted JAX pipeline: orders 0 and 1, with and without pre-alignment,
a prealign_override and a fallback_hr; the port's fast-to-oracle gap on a
true-HR burst against the JAX package's (the port's form of
tests/test_fidelity.py's gap test); and data.true_hr_burst, the numpy
true-HR recipe the card's correctness table runs on."""

import dataclasses

import imageio.v3 as iio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import ROOT, city_hr_raw_burst, nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models import handheld as jhandheld
from multi_frame_super_resolution_tpu_torch.config import RAW_BENCH, RAW_ORACLE, MergeConfig, check_supported_raw
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_raw_burst, true_hr_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models import fast_merge
from multi_frame_super_resolution_tpu_torch.models.handheld import _subsample_from_planes, handheld_superres_raw
from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray
from multi_frame_super_resolution_tpu_torch.registration import prealign

NOPRE = dataclasses.replace(RAW_ORACLE, prealign=False)


def _jax_raw(raw, cfg, override=None, fallback_hr=None):
    fn = jax.jit(jhandheld.handheld_superres_raw, static_argnums=1)
    fb = None if fallback_hr is None else jnp.asarray(fallback_hr)
    return nn(fn(jnp.asarray(raw), to_jax(cfg), override, fb))


def test_raw_oracle_config():
    assert RAW_ORACLE == dataclasses.replace(RAW_BENCH, fast=False)
    check_supported_raw(RAW_ORACLE)
    check_supported_raw(dataclasses.replace(RAW_ORACLE, merge=MergeConfig(order=0)))
    check_supported_raw(dataclasses.replace(RAW_ORACLE, merge=MergeConfig(solver="exact")))


@pytest.mark.parametrize(
    "cfg",
    [NOPRE, dataclasses.replace(NOPRE, merge=MergeConfig(order=0)),
     dataclasses.replace(NOPRE, merge=MergeConfig(solver="exact"))],
    ids=["order1-plugin", "order0", "order1-exact"],
)
def test_raw_oracle_matches_jax_pipeline(cfg):
    """The RAW oracle without pre-alignment, 4 x 64 x 128 RAW, motion up
    to 2.5 px: half-res quad subsample, tile search and LK at LKConfig()
    (the gather warp, bf16 window sums), gather robustness, the gather
    merge of the full-resolution mosaic, demosaic + bicubic fallback,
    restore. Measured 115.4 dB (order 1, plugin) and 116.4 dB (order 0)."""
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    want = _jax_raw(raw, cfg)
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    assert not LAUNCHES
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert psnr(got, want) >= 60.0


def test_raw_oracle_prealigned_matches_jax_pipeline():
    """RAW_ORACLE itself (pre-alignment on the planes, the aligned mosaic
    rebuilt from them) on a RAW burst rotated as the city burst is; the
    same transform handed over as prealign_override, and a fallback_hr
    (the fast path's output) in place of demosaic + bicubic."""
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    raw, _ = synthetic_raw_burst(np.random.default_rng(1), 4, 128, 256, 2.5, angles=angles)
    want = _jax_raw(raw, RAW_ORACLE)
    got = nn(handheld_superres_raw(tt(raw), RAW_ORACLE, device="cpu"))
    assert psnr(got, want) >= 60.0

    half = rgb_to_gray(_subsample_from_planes(fast_merge.raw_to_planes(tt(raw)), RAW_ORACLE.cfa_pattern))
    st = prealign.estimate_burst_similarity(half, RAW_ORACLE.prealign_cfg)
    override = (st, (0, 0), (64, 128))
    again = nn(handheld_superres_raw(tt(raw), RAW_ORACLE, override, device="cpu"))
    assert psnr(again, got) >= 60.0

    fallback = handheld_superres_raw(tt(raw), RAW_BENCH, device="cpu")
    want_fb = _jax_raw(raw, RAW_ORACLE, fallback_hr=nn(fallback))
    got_fb = nn(handheld_superres_raw(tt(raw), RAW_ORACLE, fallback_hr=fallback, device="cpu"))
    assert psnr(got_fb, want_fb) >= 60.0


def _hr_psnr(hr, sr, margin=16):
    return psnr(sr[margin:-margin, margin:-margin], hr[margin:-margin, margin:-margin])


def test_fast_to_oracle_gap_matches_jax_on_true_hr():
    """tests/test_fidelity.py's gap test, in the port: on a true-HR burst
    (5 frames of the city scene's top-left 256 x 512, factor 2), the
    port's true-HR PSNR of RAW_BENCH minus that of its oracle equals the
    JAX package's difference within 0.05 dB; each pipeline's own PSNR
    agrees within 0.05 dB too."""
    raw = city_hr_raw_burst(5, 2, 256, 512)
    hr = iio.imread(ROOT / "city_handheld_sr.png")[:256, :512, :3].astype(np.float32) / 255.0
    p = {}
    for name, cfg in (("fast", RAW_BENCH), ("oracle", RAW_ORACLE)):
        p["jax", name] = _hr_psnr(hr, _jax_raw(raw, cfg))
        p["port", name] = _hr_psnr(hr, nn(handheld_superres_raw(tt(raw), cfg, device="cpu")))
    for name in ("fast", "oracle"):
        assert abs(p["port", name] - p["jax", name]) <= 0.05, p
    gap_port = p["port", "fast"] - p["port", "oracle"]
    gap_jax = p["jax", "fast"] - p["jax", "oracle"]
    assert abs(gap_port - gap_jax) <= 0.05, p


def test_true_hr_burst_is_the_jax_recipe():
    """data.true_hr_burst (numpy: the port's imread, a numpy box
    downsample) against tools/eval_fidelity.py::make_hr_burst through
    torch_parity.city_hr_raw_burst on the whole tracked scene: the city
    geometry, 5 x 256 x 512, within 1e-6 (imread's 1/255 scale and the
    box means' rounding)."""
    raw, hr = true_hr_burst()
    assert raw.shape == (5, 256, 512) and raw.dtype == np.float32 and hr.shape == (512, 1024, 3)
    np.testing.assert_allclose(raw, city_hr_raw_burst(5, 2, 512, 1024), rtol=0.0, atol=1e-6)
    small, _ = true_hr_burst(hr[:64, :128], num_frames=3, factor=4)
    assert small.shape == (3, 16, 32)
