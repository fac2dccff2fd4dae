"""Global similarity pre-alignment of the port against the JAX package on
the CPU, stage by stage: ops/fourier.py, the remaps, the two-pass
similarity warp, phase correlation (quadratic and matrix-DFT peaks), the
log-polar registration, the burst estimator at both downsampling
branches, and the burst and CFA-plane warps given one transform.

Two tolerances recur. The estimates are quantized: PREALIGN_FAST refines
each phase-correlation peak on a 1/16-cell grid, and XLA's CPU FFT and
torch's round differently, so two near-equal cells could pick another
argmax; estimates are held to one refine cell and the count of exact
agreements is asserted too. The warps, given one transform, agree to f32
rounding: the port computes the JAX functions' operations in their
order, which equals the JAX functions run op by op exactly; jit lets XLA
rewrite a few of them, moving source coordinates by an ulp or two and
warped values by up to 1.9e-4 (measured) on a [0, 1] image.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt

from multi_frame_super_resolution_tpu.ops import fourier as jfourier
from multi_frame_super_resolution_tpu.ops import geometry as jgeometry
from multi_frame_super_resolution_tpu.ops import warp_fast as jwarp_fast
from multi_frame_super_resolution_tpu.registration import logpolar as jlogpolar
from multi_frame_super_resolution_tpu.registration import phase_correlation as jpc
from multi_frame_super_resolution_tpu.registration import prealign as jprealign
from multi_frame_super_resolution_tpu_torch.config import PREALIGN_FAST, RegistrationConfig
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.ops import fourier, geometry, warp_fast
from multi_frame_super_resolution_tpu_torch.registration import logpolar, phase_correlation, prealign

WARP_JIT_TOL = dict(rtol=0, atol=5e-4)  # jitted XLA rewrites, see the module docstring


def _gray_burst(h, w, seed=0, f=5):
    angles = CITY_ANGLES[:f] if f == 5 else CITY_ANGLES[:2] + CITY_ANGLES[3:]
    burst, _ = synthetic_rgb_burst(np.random.default_rng(seed), f, h, w, 2.5, angles=angles)
    return burst, (burst @ np.asarray([0.299, 0.587, 0.114], np.float32)).astype(np.float32)


def _similarity_grid(h, w, deg, s, ty, tx):
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    th = math.radians(deg)
    ca, sa = np.float32(math.cos(th)), np.float32(math.sin(th))
    yy = ys - ty - (h - 1) / 2.0
    xx = xs - tx - (w - 1) / 2.0
    return (((sa * xx + ca * yy) * s + (h - 1) / 2.0).astype(np.float32),
            ((ca * xx - sa * yy) * s + (w - 1) / 2.0).astype(np.float32))


# ---------------- ops/fourier.py ----------------

def test_fourier_tables_and_shifts_match_jax():
    rng = np.random.default_rng(0)
    x = rng.random((2, 9, 12)).astype(np.float32)
    for ours, theirs in ((fourier.fftshift2, jfourier.fftshift2), (fourier.ifftshift2, jfourier.ifftshift2),
                         (fourier.fftshift_signflip, jfourier.fftshift_signflip)):
        np.testing.assert_array_equal(nn(ours(tt(x))), np.asarray(theirs(jnp.asarray(x))))
    np.testing.assert_array_equal(fourier.apodization_window(40, 52, 5), jfourier.apodization_window(40, 52, 5))
    np.testing.assert_array_equal(fourier.high_pass_filter(33, 64), jfourier.high_pass_filter(33, 64))
    for args in ((32, 48, 0.3, 0.05, 0.02, 0.01, 2), (32, 48, 0.0, 0.0, 0.05, 0.0, 0)):
        np.testing.assert_array_equal(fourier.fourier_filter_mask(*args), jfourier.fourier_filter_mask(*args))


def test_spectra_and_filter_match_jax():
    """FFT-based: equal to the FFTs' f32 rounding."""
    rng = np.random.default_rng(1)
    a, b = (rng.random((24, 40)).astype(np.float32) for _ in range(2))
    fa, fb = np.fft.fft2(a).astype(np.complex64), np.fft.fft2(b).astype(np.complex64)
    np.testing.assert_allclose(
        nn(fourier.cross_power_spectrum(tt(fa), tt(fb))),
        np.asarray(jfourier.cross_power_spectrum(jnp.asarray(fa), jnp.asarray(fb))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        nn(fourier.conj_mul(tt(fa), tt(fb))), np.asarray(jfourier.conj_mul(jnp.asarray(fa), jnp.asarray(fb))),
        rtol=1e-6)
    np.testing.assert_allclose(
        nn(fourier.fourier_filter(tt(a), 0.3, 0.05, 0.02, 0.01, 2)),
        np.asarray(jfourier.fourier_filter(jnp.asarray(a), 0.3, 0.05, 0.02, 0.01, 2)), atol=1e-5)


# ---------------- ops/geometry.py ----------------

@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
def test_remap_matches_jax(method):
    """Gathers and the same f32 operations in the same order: bit for
    bit, for (H, W) and (H, W, C), coordinates reaching past every border."""
    rng = np.random.default_rng(2)
    img = rng.random((20, 30, 3)).astype(np.float32)
    ys = (rng.random((11, 17)) * 26 - 3).astype(np.float32)
    xs = (rng.random((11, 17)) * 36 - 3).astype(np.float32)
    for x in (img, img[..., 1]):
        np.testing.assert_array_equal(
            nn(geometry.remap(tt(x), tt(ys), tt(xs), method)),
            np.asarray(jgeometry.remap(jnp.asarray(x), jnp.asarray(ys), jnp.asarray(xs), method)))
    np.testing.assert_array_equal(
        nn(geometry.translate(tt(img), 1.25, -2.5, method)),
        np.asarray(jgeometry.translate(jnp.asarray(img), 1.25, -2.5, method)))
    ys_i, xs_i = geometry.identity_grid(4, 5)
    jy, jx = jgeometry.identity_grid(4, 5)
    np.testing.assert_array_equal(nn(ys_i), np.asarray(jy))
    np.testing.assert_array_equal(nn(xs_i), np.asarray(jx))


# ---------------- ops/warp_fast.py ----------------

@pytest.mark.parametrize(
    "deg,s,ty,tx,bound",
    [(0.0, 1.0, 3.3, -7.7, None), (5.0, 1.01, 1.5, 2.5, None), (15.0, 0.98, -3.0, 8.0, None),
     (-15.0, 1.0, 2.0, -3.0, 4)],
    ids=["0deg", "5deg", "15deg", "15deg_bound4"],
)
def test_similarity_warp_fast_matches_jax(deg, s, ty, tx, bound):
    """The two-pass warp in its direct form (two 1-D gathers) against the
    JAX function run op by op (exact) and jitted (WARP_JIT_TOL). Bound 4
    makes the hoist clamp act."""
    img = np.random.default_rng(4).random((64, 112)).astype(np.float32)
    sy, sx = _similarity_grid(64, 112, deg, s, ty, tx)
    got = nn(warp_fast.similarity_warp_fast(tt(img), tt(sy), tt(sx), bound))
    with jax.disable_jit():
        eager = np.asarray(jwarp_fast.similarity_warp_fast(jnp.asarray(img), jnp.asarray(sy), jnp.asarray(sx), bound))
    np.testing.assert_allclose(got, eager, rtol=0, atol=1e-6)
    jitted = jax.jit(jwarp_fast.similarity_warp_fast, static_argnums=3)(img, sy, sx, bound)
    np.testing.assert_allclose(got, np.asarray(jitted), **WARP_JIT_TOL)
    if bound is not None:  # the clamp moved content: not the unbounded warp
        assert np.abs(got - nn(warp_fast.similarity_warp_fast(tt(img), tt(sy), tt(sx)))).max() > 0.05


def test_similarity_warp_fast_batches_planes():
    """Planes sharing one grid, and per-plane grids, equal the warp of
    each plane alone."""
    rng = np.random.default_rng(5)
    img = tt(rng.random((2, 3, 32, 48)).astype(np.float32))
    grids = [_similarity_grid(32, 48, d, 1.0, 1.0, -1.0) for d in (4.0, -9.0)]
    gy = tt(np.stack([g[0] for g in grids]))[:, None]
    gx = tt(np.stack([g[1] for g in grids]))[:, None]
    out = warp_fast.similarity_warp_fast(img, gy, gx)
    for b in range(2):
        for c in range(3):
            assert torch.equal(out[b, c], warp_fast.similarity_warp_fast(img[b, c], gy[b, 0], gx[b, 0]))
    assert warp_fast.default_warp_bound(128, 256) == jwarp_fast.default_warp_bound(128, 256)


# ---------------- phase correlation and log-polar registration ----------------

@pytest.mark.parametrize("refine", [0, 16])
def test_phase_correlate_matches_jax(refine):
    """Integer peak plus the quadratic step, or the matrix-DFT refinement:
    within one refine cell (1/16 px) or 1e-3 px of the quadratic step.
    The whitened spectrum turns the FFTs' rounding in near-empty bins
    into unit phasors, so a weak peak's height moves by up to ~1e-3
    (measured 9.7e-4 at height 0.26): atol 2e-3."""
    burst, gray = _gray_burst(64, 96, seed=1)
    a = gray[0]
    b = np.stack([np.roll(a, (3, -5), (0, 1)), gray[1]])
    win = fourier.apodization_window(64, 96, 7)
    got_s, got_p = phase_correlation.phase_correlate_batched(tt(a), tt(b), window=tt(win), refine=refine)
    for i in range(2):
        want_s, want_p = jax.jit(lambda x, y: jpc.phase_correlate(x, y, window=jnp.asarray(win), refine=refine))(
            a, b[i])
        np.testing.assert_allclose(nn(got_s[i]), np.asarray(want_s), atol=1.0 / 16 if refine else 1e-3)
        np.testing.assert_allclose(float(got_p[i]), float(want_p), atol=2e-3)
    # b(x) ~= a(x + d): the roll by (3, -5) is found as d = (-3, 5), up to
    # the bias of the window, which stays put while the content rolls
    # (measured 0.125 px on both sides)
    np.testing.assert_allclose(nn(got_s[0]), [-3.0, 5.0], atol=0.15)
    np.testing.assert_allclose(
        nn(phase_correlation.correlation_surface(tt(a), tt(b[1]))),
        np.asarray(jpc.correlation_surface(jnp.asarray(a), jnp.asarray(b[1]))), atol=1e-5)


def test_log_polar_maps_and_register_similarity_match_jax():
    """The maps are the same numpy; register_similarity (log-polar
    rotation / scale, unrotate, translation) on the reference-parity
    settings (quadratic peaks: to f32 rounding) and on PREALIGN_FAST's
    (refined peaks: within one refine cell, rotation pi / (size - 1) / 16;
    here exactly) estimate the same transforms."""
    for ours, theirs in zip(logpolar.log_polar_maps(64, 96, 2), jlogpolar.log_polar_maps(64, 96, 2)):
        np.testing.assert_array_equal(ours, theirs)
    assert logpolar.log_polar_params(64, 96) == jlogpolar.log_polar_params(64, 96)
    _, gray = _gray_burst(64, 128, seed=1)
    size = 128
    for cfg in (RegistrationConfig(), PREALIGN_FAST):
        got = logpolar.register_similarity_batched(tt(gray[0]), tt(gray[1:]), cfg)
        want = jax.jit(jax.vmap(lambda g: jlogpolar.register_similarity(jnp.asarray(gray[0]), g, to_jax(cfg))))(gray[1:])
        np.testing.assert_allclose(nn(got.rotation), np.asarray(want.rotation), atol=math.pi / (size - 1) / 16)
        np.testing.assert_allclose(nn(got.scale), np.asarray(want.scale), rtol=1e-3)
        np.testing.assert_allclose(nn(got.translation), np.asarray(want.translation), atol=1.0 / 16 + 1e-3)
        if cfg.peak_upsample:
            assert np.array_equal(nn(got.rotation), np.asarray(want.rotation))


@pytest.mark.parametrize("hw,ds", [((64, 128), 1), ((128, 256), 2)], ids=["ds1", "ds2"])
def test_estimate_burst_similarity_matches_jax(hw, ds):
    """Both branches of the downsampling loop: 64 x 128 luma estimates at
    full resolution (and radius step 1), 128 x 256 at ds=2 (radius step
    2, translation scaled back). Every estimate within one refine cell;
    measured: all 8 frames of 2 bursts agree exactly."""
    h, w = hw
    exact = 0
    for seed in (0, 1):
        _, gray = _gray_burst(h, w, seed)
        np.testing.assert_array_equal(nn(prealign._box_down(tt(gray), 2)),
                                      np.asarray(jprealign._box_down(jnp.asarray(gray), 2)))
        got = prealign.estimate_burst_similarity(tt(gray), PREALIGN_FAST)
        want = jax.jit(lambda g: jprealign.estimate_burst_similarity(g, to_jax(PREALIGN_FAST)))(gray)
        size = max(h, w) // ds
        np.testing.assert_allclose(nn(got.rotation), np.asarray(want.rotation), atol=math.pi / (size - 1) / 16 + 1e-7)
        np.testing.assert_allclose(nn(got.translation), np.asarray(want.translation), atol=ds / 16 + 1e-4)
        np.testing.assert_allclose(nn(got.scale), np.asarray(want.scale), rtol=1e-3)
        exact += int(np.sum(nn(got.rotation) == np.asarray(want.rotation)))
        no_tr = prealign.estimate_burst_similarity(tt(gray), PREALIGN_FAST, with_translation=False)
        assert torch.equal(no_tr.rotation, got.rotation) and not no_tr.translation.any()
    assert exact == 8
    if ds == 2:  # the 15-degree frame of the city rotations is found
        assert abs(abs(math.degrees(float(got.rotation[3]))) - 15.0) < 1.0


# ---------------- the warps, given one transform ----------------

def _transform(f, seed=0):
    rng = np.random.default_rng(seed)
    st = jlogpolar.SimilarityTransform(
        rotation=jnp.asarray(np.deg2rad([0.05, 5.0, -9.0, 14.0][: f - 1]).astype(np.float32)),
        scale=jnp.asarray((1.0 + 0.004 * rng.standard_normal(f - 1)).astype(np.float32)),
        translation=jnp.asarray((rng.random((f - 1, 2)) * 6 - 3).astype(np.float32)),
        response=jnp.ones(f - 1, jnp.float32),
    )
    return st, logpolar.similarity_from_numpy(jax.tree_util.tree_map(np.asarray, st))


@pytest.mark.parametrize("fast", [True, False], ids=["fast_warp", "remap"])
def test_apply_burst_similarity_matches_jax(fast):
    """RGB alternates and their validity, the first frame under the
    significance gate (passed through, valid 1)."""
    import dataclasses

    burst, _ = _gray_burst(48, 80, seed=2)
    cfg = dataclasses.replace(PREALIGN_FAST, fast_warp=fast)
    jst, st = _transform(5)
    got_b, got_v = prealign.apply_burst_similarity(tt(burst), st, cfg)
    with jax.disable_jit():
        eager_b, _ = jprealign.apply_burst_similarity(jnp.asarray(burst), jst, to_jax(cfg))
    np.testing.assert_array_equal(nn(got_b), np.asarray(eager_b))
    want_b, want_v = jax.jit(lambda b: jprealign.apply_burst_similarity(b, jst, to_jax(cfg)))(burst)
    np.testing.assert_array_equal(nn(got_v), np.asarray(want_v))
    np.testing.assert_allclose(nn(got_b), np.asarray(want_b), **WARP_JIT_TOL)
    assert torch.equal(got_b[:2], tt(burst[:2]))  # frame 0, and frame 1 under the gate
    assert 0.0 < float(got_v[4].mean()) < 1.0


def test_apply_planes_similarity_matches_jax():
    """CFA planes with per-plane (+a/2, +b/2) site offsets and the 6e-3
    gate; the validity mask's warp-bound saturation test included."""
    rng = np.random.default_rng(3)
    planes = rng.random((5, 2, 2, 40, 72)).astype(np.float32)
    jst, st = _transform(5, seed=1)
    got_p, got_v = prealign.apply_planes_similarity(tt(planes), st, PREALIGN_FAST)
    with jax.disable_jit():
        eager_p, _ = jprealign.apply_planes_similarity(jnp.asarray(planes), jst, to_jax(PREALIGN_FAST))
    np.testing.assert_array_equal(nn(got_p), np.asarray(eager_p))
    want_p, want_v = jax.jit(lambda p: jprealign.apply_planes_similarity(p, jst, to_jax(PREALIGN_FAST)))(planes)
    np.testing.assert_array_equal(nn(got_v), np.asarray(want_v))
    np.testing.assert_allclose(nn(got_p), np.asarray(want_p), **WARP_JIT_TOL)
    sy, sx = prealign._source_grid(40, 72, st)
    jy, jx = jax.vmap(lambda s: jprealign._source_grid(40, 72, s))(jst)
    np.testing.assert_array_equal(nn(sy), np.asarray(jy))
    np.testing.assert_array_equal(nn(sx), np.asarray(jx))
    for fast in (True, False):
        np.testing.assert_array_equal(
            nn(prealign._source_valid(sy[3], sx[3], 40, 72, fast)),
            np.asarray(jprealign._source_valid(jy[3], jx[3], 40, 72, fast)))
    np.testing.assert_array_equal(nn(prealign.similarity_is_significant(st)),
                                  np.asarray(jprealign.similarity_is_significant(jst)))


def test_prewarp_frame_and_prealign_burst_match_jax():
    """prewarp_frame on an (H, W) frame through the two-pass warp (the JAX
    warp takes channel-leading planes only) and on an (H, W, 3) frame
    through the remap; then the whole burst stage."""
    burst, gray = _gray_burst(64, 128, seed=0, f=4)
    jst, st = _transform(4)
    one = jax.tree_util.tree_map(lambda x: x[2], jst)
    for fast, frame in ((True, gray[1]), (False, burst[1])):
        got_w, got_v = prealign.prewarp_frame(tt(frame), logpolar.similarity_from_numpy(
            jax.tree_util.tree_map(lambda x: np.asarray(x)[None], one)), fast=fast)
        want_w, want_v = jax.jit(lambda fr: jprealign.prewarp_frame(fr, one, fast=fast))(frame)
        np.testing.assert_allclose(nn(got_w), np.asarray(want_w), **WARP_JIT_TOL)
        np.testing.assert_array_equal(nn(got_v), np.asarray(want_v))
    got_b, got_v = prealign.prealign_burst(tt(burst), tt(gray), PREALIGN_FAST)
    want_b, want_v = jax.jit(lambda b, g: jprealign.prealign_burst(b, g, to_jax(PREALIGN_FAST)))(burst, gray)
    np.testing.assert_array_equal(nn(got_v), np.asarray(want_v))
    np.testing.assert_allclose(nn(got_b), np.asarray(want_b), **WARP_JIT_TOL)
