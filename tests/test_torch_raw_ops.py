"""Parity of the RAW path's building blocks with the JAX package on the same
numpy inputs: CFA planes, phase-domain upsample and interleave, the
windows branch of the alignment (search windows, SSD surfaces, shift
fields), the plugin solve, and the noise-gated restore."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu.models import handheld as jhandheld
from multi_frame_super_resolution_tpu.models import merge as jmerge
from multi_frame_super_resolution_tpu.ops import restore as jrestore
from multi_frame_super_resolution_tpu.registration import align as jalign
from multi_frame_super_resolution_tpu.registration import tiles as jtiles
from multi_frame_super_resolution_tpu.data.datasets import mosaic_rggb as jax_mosaic_rggb
from multi_frame_super_resolution_tpu_torch.config import AlignConfig
from multi_frame_super_resolution_tpu_torch.data import (
    mosaic_rggb,
    synthetic_burst,
    synthetic_raw_burst,
    synthetic_rgb_burst,
)
from multi_frame_super_resolution_tpu_torch.models import fast_merge, handheld, merge
from multi_frame_super_resolution_tpu_torch.ops import restore
from multi_frame_super_resolution_tpu_torch.registration import align, tiles

jwarp = importlib.import_module("multi_frame_super_resolution_tpu.ops.warp_fast")
twarp = importlib.import_module("multi_frame_super_resolution_tpu_torch.ops.warp_fast")

CFAS = [((0, 1), (1, 2)), ((2, 1), (1, 0)), ((1, 0), (2, 1))]


@pytest.mark.parametrize("cfa", CFAS)
def test_mosaic_and_raw_burst(cfa):
    rgb, shifts = synthetic_rgb_burst(np.random.default_rng(4), 3, 16, 24, 2.0)
    for frame in rgb:
        np.testing.assert_array_equal(mosaic_rggb(frame, cfa), jax_mosaic_rggb(frame, cfa))
    raw, raw_shifts = synthetic_raw_burst(np.random.default_rng(4), 3, 16, 24, 2.0, cfa)
    np.testing.assert_array_equal(raw, np.stack([mosaic_rggb(f, cfa) for f in rgb]))
    np.testing.assert_array_equal(raw_shifts, shifts)


def test_raw_planes_round_trip(rng):
    """Views against the JAX selector matmuls: exact on the CPU."""
    raw = rng.random((3, 12, 20)).astype(np.float32)
    planes = fast_merge.raw_to_planes(tt(raw))
    np.testing.assert_array_equal(nn(planes), nn(jfm.raw_to_planes(jnp.asarray(raw))))
    np.testing.assert_array_equal(nn(fast_merge.planes_to_raw(planes)), raw)
    np.testing.assert_array_equal(
        nn(fast_merge.planes_to_raw(planes)),
        nn(jfm.planes_to_raw(jfm.raw_to_planes(jnp.asarray(raw)))),
    )


@pytest.mark.parametrize("cfa", CFAS)
def test_subsample_from_planes(rng, cfa):
    planes = rng.random((2, 2, 2, 6, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        nn(handheld._subsample_from_planes(tt(planes), cfa)),
        nn(jhandheld._subsample_from_planes(jnp.asarray(planes), cfa)),
    )


@pytest.mark.parametrize("s,method", [(4, "bilinear"), (2, "bicubic")])
def test_upsample_phases_and_interleave(rng, s, method):
    img = rng.random((6, 10, 3)).astype(np.float32)
    got = twarp.upsample_int_phases_planes(tt(img), s, method)
    want = jwarp.upsample_int_phases_planes(jnp.asarray(img), s, method)
    np.testing.assert_array_equal(nn(got), nn(want))
    np.testing.assert_array_equal(
        nn(twarp.interleave_phases_planes(got)), nn(jwarp.interleave_phases_planes(want))
    )
    np.testing.assert_array_equal(
        nn(twarp.interleave_phases_planes(got)), nn(twarp.upsample_int(tt(img), s, method))
    )


def test_grad_phases_and_grad_image(rng):
    x = rng.random((4, 4, 3, 5, 7)).astype(np.float32)
    for g, w_ in zip(fast_merge.grad_phases(tt(x)), jfm.grad_phases(jnp.asarray(x))):
        np.testing.assert_array_equal(nn(g), nn(w_))
    img = rng.random((9, 11, 3)).astype(np.float32)
    for g, w_ in zip(merge.grad_image(tt(img)), jmerge.grad_image(jnp.asarray(img))):
        np.testing.assert_array_equal(nn(g), nn(w_))


@pytest.mark.parametrize("precomputed,iters", [(True, 1), (False, 2)])
def test_solve_plugin_and_weighting(rng, precomputed, iters):
    shape = (4, 4, 3, 6, 8)
    m00 = (rng.random(shape) * 3.0).astype(np.float32)
    m00[0, 0, 0, :2] = 0.0  # no coverage
    m01 = rng.standard_normal(shape).astype(np.float32)
    m02 = rng.standard_normal(shape).astype(np.float32)
    b0 = (rng.random(shape) * m00).astype(np.float32)
    moments = (m00, m01, m02, b0)
    est, m_t = merge.solve_plugin([tt(m) for m in moments], fast_merge.grad_phases, iters, precomputed)
    est_j, m_j = jmerge.solve_plugin(
        tuple(map(jnp.asarray, moments)), jfm.grad_phases, iters, precomputed
    )
    np.testing.assert_allclose(nn(est), nn(est_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(nn(m_t), nn(m_j))
    fb = rng.random(shape).astype(np.float32)
    np.testing.assert_allclose(
        nn(merge.apply_weighting_order1(est, m_t, tt(fb), 0.5)),
        nn(jmerge.apply_weighting_order1(est_j, m_j, jnp.asarray(fb), 0.5)),
        rtol=1e-6, atol=1e-6,
    )


def test_ssd_surface_windows(rng):
    """Expanded form tsq + wsq - 2 cc with integral-image window energies:
    sums of ~256 f32 terms in another order, rtol 1e-5."""
    ref = rng.random((40, 56)).astype(np.float32)
    alt = rng.random((2, 40, 56)).astype(np.float32)
    shifts = rng.integers(-3, 4, (2, 3, 4, 2)).astype(np.int32)
    ref_tiles = tiles.extract_ref_tiles(tt(ref), 16)
    np.testing.assert_array_equal(nn(ref_tiles), nn(jtiles.extract_ref_tiles(jnp.asarray(ref), 16)))
    windows = tiles.extract_search_windows_batched(tt(alt), 16, 4, tt(shifts))
    got = tiles.ssd_surface(ref_tiles, windows, 4)
    assert got.shape == (2, 3, 4, 9, 9)
    for i in range(2):
        want = jtiles.ssd_surface(jnp.asarray(nn(ref_tiles)), jnp.asarray(nn(windows[i])), 4)
        np.testing.assert_allclose(nn(got[i]), nn(want), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(
            nn(tiles._window_energies(windows[i], 16)),
            nn(jtiles._window_energies(jnp.asarray(nn(windows[i])), 16)),
            rtol=1e-6,
        )


@pytest.mark.parametrize(
    "cfg",
    [
        AlignConfig(tile_size=16, search_radius=4, levels=2, fast_extract=False),
        AlignConfig(tile_size=16, search_radius=9, levels=2),  # radius > tile/2
        AlignConfig(tile_size=8, search_radius=5, levels=2),
    ],
)
def test_align_windows_branch(cfg):
    """The windows branch of align_frames against the jitted JAX function.
    The quadratic subpixel step turns f32 rounding of the SSD sums into
    ~1e-4 px: on this burst the JAX function run op by op differs from its
    own jitted run by up to 6e-4 px (tile 8: 8e-4), and the port's expanded
    form lands within 1e-4 (tile 16, radius 4), 3e-4 (radius 9) and 8e-4
    (tile 8) of the jitted run. Bound: 1e-3 px, no tile moved."""
    burst, _ = synthetic_burst(np.random.default_rng(2), 4, 64, 96, 3.0)
    got = align.align_burst(tt(burst), cfg)
    want = jax.jit(jalign.align_burst, static_argnums=1)(jnp.asarray(burst), to_jax(cfg))
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-3)


def test_restore_factors_match_the_shipped_kernel():
    kernel, factors = restore.restore_factors(restore.RESTORE_KERNEL_FIT)
    np.testing.assert_array_equal(restore.RESTORE_KERNEL_FIT, jrestore.RESTORE_KERNEL_FIT)
    np.testing.assert_allclose(kernel, jrestore.RESTORE_KERNEL, rtol=0, atol=1e-7)
    for (uy, vx), (uy_j, vx_j) in zip(factors, jrestore.RESTORE_FACTORS):
        np.testing.assert_allclose(uy, uy_j, rtol=0, atol=1e-7)
        np.testing.assert_allclose(vx, vx_j, rtol=0, atol=1e-7)
    np.testing.assert_allclose(sum(np.outer(u, v) for u, v in factors), kernel, atol=1e-6)


@pytest.mark.parametrize("gain", [None, 0.0, 0.37, 1.0])
def test_restore_phases(rng, gain):
    """Same taps summed in the same order: exact up to one f32 rounding."""
    planes = rng.random((4, 4, 3, 9, 12)).astype(np.float32)
    g_t = None if gain is None else torch.tensor(gain, dtype=torch.float32)
    g_j = None if gain is None else jnp.float32(gain)
    np.testing.assert_allclose(
        nn(restore.restore_phases(tt(planes), gain=g_t)),
        nn(jrestore.restore_phases(jnp.asarray(planes), gain=g_j)),
        rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_temporal_noise_stat_and_gain(noise):
    """The statistic to rtol 1e-5 and the gain of the gate on each side of
    its thresholds (0.014, 0.020)."""
    rng = np.random.default_rng(5)
    gray, _ = synthetic_burst(rng, 4, 48, 64, 0.0)
    gray = (gray + noise * rng.standard_normal(gray.shape)).astype(np.float32)
    res = (rng.random((3, 48, 64, 2)) * 0.4 - 0.2).astype(np.float32)
    got = restore.temporal_noise_stat(tt(gray), residual=tt(res))
    want = jrestore.temporal_noise_stat(jnp.asarray(gray), residual=jnp.asarray(res))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for stat in (float(want), 0.011, 0.017, 0.03):
        np.testing.assert_allclose(
            float(restore.restore_gain(torch.tensor(stat), 0.014, 0.020)),
            float(jrestore.restore_gain(jnp.float32(stat), 0.014, 0.020)),
            rtol=1e-6,
        )
