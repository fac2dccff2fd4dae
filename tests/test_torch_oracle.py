"""The gather (oracle) path's building blocks and the RGB oracle, against
the JAX package on the same numpy inputs: the demosaics
(ops/debayer.py), the output-resolution restore and the flow-registered
noise statistic (ops/restore.py), the gather robustness (bounded=0), the
gather merges at orders 0 and 1 with the exact 3x3 solve
(models/merge.py), and handheld_superres(fast=False) end to end against
the jitted JAX pipeline. None of these reaches a Pallas kernel in the JAX
package, or a kernel of csrc/ in the port."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models import handheld as jhandheld
from multi_frame_super_resolution_tpu.models import merge as jmerge
from multi_frame_super_resolution_tpu.models import robustness as jrobustness
from multi_frame_super_resolution_tpu.ops import restore as jrestore
from multi_frame_super_resolution_tpu_torch.config import (
    RGB_ORACLE,
    HandheldConfig,
    MergeConfig,
    RobustnessConfig,
    check_supported,
)
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models import merge, robustness
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres
from multi_frame_super_resolution_tpu_torch.ops import restore
from multi_frame_super_resolution_tpu_torch.registration import prealign

# the JAX package's ops re-exports a function named debayer
jdebayer = importlib.import_module("multi_frame_super_resolution_tpu.ops.debayer")
# and so does the port's
debayer = importlib.import_module("multi_frame_super_resolution_tpu_torch.ops.debayer")

CFAS = [debayer.RGGB, debayer.BGGR, debayer.GRBG, debayer.GBRG]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfa", CFAS)
@pytest.mark.parametrize("h,w", [(32, 48), (31, 45)])
def test_debayer_matches_jax(cfa, h, w):
    """The Wu-Zhang demosaic on an even and a ragged mosaic, with a black
    point and per-channel scales: the same expressions in the same order,
    within 1e-5 (measured: bit-equal or one ulp)."""
    raw = np.random.default_rng(h).random((h, w)).astype(np.float32)
    kw = dict(black_point=(0.02, 0.01, 0.03), scale=(1.1, 0.9, 1.2))
    want = nn(jax.jit(jdebayer.debayer, static_argnums=(1, 2, 3))(jnp.asarray(raw), cfa, *kw.values()))
    got = nn(debayer.debayer(tt(raw), cfa, **kw))
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(debayer.cfa_channel_map(h, w, cfa), jdebayer.cfa_channel_map(h, w, cfa))


@pytest.mark.parametrize("cfa", CFAS)
def test_debayer_subsample_matches_jax(cfa):
    """Each 2 x 2 quad to one RGB pixel, the greens averaged; a ragged
    mosaic drops its last row and column; a batch of frames at once."""
    raw = np.random.default_rng(1).random((3, 21, 34)).astype(np.float32)
    got = nn(debayer.debayer_subsample(tt(raw), cfa, 2.0))
    for f in range(3):
        want = nn(jdebayer.debayer_subsample(jnp.asarray(raw[f]), cfa, 2.0))
        np.testing.assert_allclose(got[f], want, **TOL)


@pytest.mark.parametrize("shape", [(24, 40, 3), (17, 29)])
@pytest.mark.parametrize("gain", [None, 0.4])
def test_restore_image_matches_jax(shape, gain):
    """The 7 x 7 restore FIR at output resolution, edge-clamped, on a
    channel-last image and a plane, at full strength and gated."""
    img = np.random.default_rng(2).random(shape).astype(np.float32)
    g = None if gain is None else jnp.float32(gain)
    want = nn(jrestore.restore_image(jnp.asarray(img), gain=g))
    got = nn(restore.restore_image(tt(img), gain=None if gain is None else torch.tensor(gain)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("noise", [0.003, 0.03])
def test_temporal_noise_stat_with_flows_matches_jax(noise):
    """The statistic of unwarped frames registered by their rounded flows
    (up to +-5 px, some at exact halves, where both round to even) and
    the residual flows - round(flows)."""
    rng = np.random.default_rng(3)
    gray = (rng.random((4, 48, 64)) * 0.5 + noise * rng.standard_normal((4, 48, 64))).astype(np.float32)
    flows = ((rng.random((4, 48, 64, 2)) - 0.5) * 10.0).astype(np.float32)
    flows[:, ::7, ::5] = np.round(flows[:, ::7, ::5]) + 0.5
    want = float(jrestore.temporal_noise_stat(jnp.asarray(gray), jnp.asarray(flows)))
    got = float(restore.temporal_noise_stat(tt(gray), flows=tt(flows)))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)


def test_gather_robustness_matches_jax():
    """bounded=0: the moving frames' 3 x 3 means gathered at the rounded
    flow, per pixel, clamped at the borders (flows up to +-8 px, beyond
    any bounded warp); three alternates in one call against the JAX
    function frame by frame."""
    rng = np.random.default_rng(4)
    ref = rng.random((40, 56, 3)).astype(np.float32)
    moved = (ref[None] + 0.05 * rng.standard_normal((3, 40, 56, 3))).astype(np.float32)
    flows = ((rng.random((3, 40, 56, 2)) - 0.5) * 16.0).astype(np.float32)
    cfg = RobustnessConfig()
    got = nn(robustness.robustness_mask(tt(ref), tt(moved), tt(flows), cfg, bounded=0))
    for f in range(3):
        want = nn(jrobustness.robustness_mask(
            jnp.asarray(ref), jnp.asarray(moved[f]), jnp.asarray(flows[f]), to_jax(cfg), bounded=0))
        np.testing.assert_allclose(got[f], want, **TOL)


def _merge_inputs(rng, f, h, w, raw=False):
    frames = rng.random((f, h, w) if raw else (f, h, w, 3)).astype(np.float32)
    flows = ((rng.random((f, h, w, 2)) - 0.5) * 6.0).astype(np.float32)
    cshape = (f, h // 2, w // 2, 3) if raw else (f, h, w, 3)
    cert = rng.random(cshape).astype(np.float32)
    omega = (0.5 + rng.random((h, w, 3))).astype(np.float32)
    omega[..., 2] *= 0.1
    return frames, flows, cert, omega


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("scale,radius", [(2, 2), (3, 1)])
def test_merge_burst_rgb_matches_jax(order, scale, radius):
    """The gather merge of 3 RGB frames with flows up to +-3 px (nearest
    samples off the image: the reads clamp, the displacements do not):
    (num, den) or the 9 moments. The port adds each frame's taps, then
    the frames; the JAX scan adds every term to one sum. Order 0 within
    1e-5; the moments, whose terms reach dy^2 ~ 40 in either sign, at
    atol 1e-4 (ORDER1_TOL; measured 1.02e-5 on one of 15,120 values at
    scale 3)."""
    ins = _merge_inputs(np.random.default_rng(5), 3, 20, 28)
    fn = jax.jit(jmerge.merge_burst_rgb, static_argnums=(4, 5, 6))
    want = fn(*map(jnp.asarray, ins), scale, radius, order)
    got = merge.merge_burst_rgb(*map(tt, ins), scale, radius, order)
    assert len(got) == len(want) == (9 if order else 2)
    for g, w_ in zip(got, want):
        assert g.shape == (20 * scale, 28 * scale, 3)
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-5, atol=1e-4 if order else 1e-5)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("cfa", [debayer.RGGB, debayer.GBRG])
def test_merge_burst_raw_matches_jax(order, cfa):
    """The RAW gather merge: each sample into its own CFA channel (the JAX
    function's one-hot product, computed as a select), the reads clamped
    first, certainty from the half-resolution grid."""
    ins = _merge_inputs(np.random.default_rng(6), 3, 20, 28, raw=True)
    fn = jax.jit(jmerge.merge_burst_raw, static_argnums=(4, 5, 6, 7))
    want = fn(*map(jnp.asarray, ins), cfa, 2, 2, order)
    got = merge.merge_burst_raw(*map(tt, ins), cfa, 2, 2, order)
    assert len(got) == len(want) == (9 if order else 2)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ridge", [0.02, 0.0])
def test_solve_order1_matches_jax(ridge):
    """The adjugate solve on moments of real gather merges, with the
    default ridge and none, plus planted cells: all moments zero
    (estimate 0) and, without ridge, a singular system (gradient rows
    zero: the order-0 fallback b0 / m00)."""
    ins = _merge_inputs(np.random.default_rng(7), 3, 16, 24)
    moments = [np.array(m) for m in jmerge.merge_burst_rgb(*map(jnp.asarray, ins), 2, 2, 1)]
    for m in moments:  # no coverage
        m[0, 0] = 0.0
    for k in (1, 2, 3, 4, 5):  # a singular 3 x 3 system without the ridge
        moments[k][0, 1] = 0.0
    want_est, want_m00 = jmerge.solve_order1(tuple(map(jnp.asarray, moments)), ridge)
    est, m00 = merge.solve_order1(tuple(map(tt, moments)), ridge)
    np.testing.assert_allclose(nn(est), nn(want_est), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(nn(m00), nn(want_m00))
    assert (nn(est)[0, 0] == 0.0).all()
    if ridge == 0.0:
        order0 = moments[6][0, 1] / np.maximum(moments[0][0, 1], 1e-8)
        np.testing.assert_allclose(nn(est)[0, 1], order0, rtol=1e-6)


def _jax_run(burst, cfg, override=None):
    fn = jax.jit(jhandheld.handheld_superres, static_argnums=1)
    return nn(fn(jnp.asarray(burst), to_jax(cfg), override))


def test_oracle_configs():
    """RGB_ORACLE is the JAX default on the oracle; check_supported now
    takes fast=False and the exact solve on both branches."""
    assert RGB_ORACLE == HandheldConfig(fast=False)
    check_supported(RGB_ORACLE)
    check_supported(dataclasses.replace(RGB_ORACLE, merge=MergeConfig(rgb_order=1, solver="exact")))
    check_supported(dataclasses.replace(RGB_ORACLE, merge=MergeConfig(rgb_order=1)))


@pytest.mark.parametrize(
    "cfg",
    [
        dataclasses.replace(RGB_ORACLE, prealign=False),
        HandheldConfig(fast=False, prealign=False, merge=MergeConfig(rgb_order=1, solver="exact")),
        HandheldConfig(fast=False, prealign=False, merge=MergeConfig(rgb_order=1)),
    ],
    ids=["order0", "order1-exact", "order1-plugin"],
)
def test_rgb_oracle_matches_jax_pipeline(cfg):
    """handheld_superres with fast=False, no pre-alignment, F = 4 at
    64 x 128 with motion up to 2.5 px: flows from the tile search, LK at
    LKConfig() (the gather warp, bf16 window sums), the gather robustness
    and merge, the gated output-resolution restore. Measured 117.6 dB
    (order 0), 117.4 dB (order 1, plugin); 60 dB as for the fast slices."""
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    want = _jax_run(burst, cfg)
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst), cfg, device="cpu"))
    assert not LAUNCHES
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert psnr(got, want) >= 60.0


def test_rgb_oracle_prealigned_matches_jax_pipeline():
    """RGB_ORACLE itself (pre-alignment on) on a burst rotated as the city
    burst is, and the same with the estimated transform handed over as
    prealign_override."""
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    burst, _ = synthetic_rgb_burst(np.random.default_rng(1), 4, 64, 128, 2.5, angles=angles)
    want = _jax_run(burst, RGB_ORACLE)
    got = nn(handheld_superres(tt(burst), RGB_ORACLE, device="cpu"))
    assert psnr(got, want) >= 60.0
    from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray

    st = prealign.estimate_burst_similarity(rgb_to_gray(tt(burst)), RGB_ORACLE.prealign_cfg)
    override = (st, (0, 0), (64, 128))
    again = nn(handheld_superres(tt(burst), RGB_ORACLE, override, device="cpu"))
    assert psnr(again, got) >= 60.0
