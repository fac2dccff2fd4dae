"""Parity of the PyTorch port's registration stages with the JAX package:
SSD surfaces, argmin, the tile pyramid, Lucas-Kanade and robustness, on
the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.config import AlignConfig, LKConfig, RobustnessConfig
from multi_frame_super_resolution_tpu.models.robustness import robustness_mask as jrobust
from multi_frame_super_resolution_tpu.registration import align as jalign
from multi_frame_super_resolution_tpu.registration import lucas_kanade as jlk
from multi_frame_super_resolution_tpu.registration import subpixel as jsub
from multi_frame_super_resolution_tpu.registration import tiles as jtiles
from multi_frame_super_resolution_tpu_torch.data import synthetic_burst
from multi_frame_super_resolution_tpu_torch.models.robustness import robustness_mask
from multi_frame_super_resolution_tpu_torch.registration import (
    align,
    lucas_kanade,
    subpixel,
    tiles,
)


def test_quadratic_subpixel_min(rng):
    patch = rng.standard_normal((40, 3, 3)).astype(np.float32)
    patch[:20] += 3.0 * (np.arange(3)[:, None] - 1.0) ** 2  # well-posed bowls
    np.testing.assert_allclose(
        nn(subpixel.quadratic_subpixel_min(tt(patch))),
        nn(jsub.quadratic_subpixel_min(jnp.asarray(patch))),
        atol=1e-5,
    )


def test_ssd_surface_and_argmin(rng):
    """The expanded-form surfaces agree to f32 rounding of sums of ~256
    terms (relative 1e-5 of the surface scale); the argmin step is then
    compared on the JAX surfaces, where it must agree exactly."""
    ref = rng.random((40, 56)).astype(np.float32)  # not a tile multiple
    alts = rng.random((2, 40, 56)).astype(np.float32)
    want = np.stack(
        [nn(jtiles.ssd_surface_image(jnp.asarray(ref), jnp.asarray(a), 16, 4)) for a in alts]
    )
    got = nn(tiles.ssd_surface_image(tt(ref), tt(alts), 16, 4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    # plant clear interior minima in half the tiles so the subpixel fit runs
    want[0, :, :, 3:6, 2:5] -= 50.0 * np.asarray([[1, 2, 1], [2, 3, 2], [1, 2, 1]])
    for sub in (True, False):
        np.testing.assert_allclose(
            nn(tiles.find_min_shift(tt(want), 4, 0.0, sub)),
            np.stack([nn(jtiles.find_min_shift(jnp.asarray(s), 4, 0.0, sub)) for s in want]),
            atol=1e-6,
        )


def test_upsample_shift_field(rng):
    s = (rng.random((2, 3, 5, 2)) * 4 - 2).astype(np.float32)
    want = np.stack([nn(jtiles.upsample_shift_field(jnp.asarray(x), 6, 10, 2.0)) for x in s])
    np.testing.assert_allclose(nn(tiles.upsample_shift_field(tt(s), 6, 10, 2.0)), want, atol=1e-6)


@pytest.mark.parametrize("h,w", [(64, 96), (64, 80)])
def test_flow_from_tile_shifts(rng, h, w):
    """Exact tile multiples take the polyphase upsample, the rest the resize."""
    s = (rng.random((2, 2, 3, 2)) * 6 - 3).astype(np.float32)
    want = np.stack([nn(jalign.flow_from_tile_shifts(jnp.asarray(x), 32, h, w)) for x in s])
    np.testing.assert_allclose(
        nn(align.flow_from_tile_shifts(tt(s), 32, h, w)), want, atol=1e-5
    )


def test_align_burst_shift_fields(rng):
    """The whole pyramid search, tile warps included: shift fields agree to
    the rounding of the subpixel fit (no argmin moves)."""
    gray, _ = synthetic_burst(rng, num_frames=3, height=64, width=96, max_shift=6.0)
    cfg = AlignConfig()
    want = nn(jax.jit(jalign.align_burst, static_argnums=1)(jnp.asarray(gray), cfg))
    got = nn(align.align_burst(tt(gray), cfg))
    assert np.abs(want).max() > 1.0  # the search moved
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("bf16", [True, False])
def test_lk_refine(rng, bf16):
    """Two bounded LK iterations on a shifted pair. bf16 window sums round
    at the same places in both; an occasional partial sum a bf16 step
    apart moves a flow by ~1e-4 px."""
    burst, _ = synthetic_burst(rng, num_frames=3, height=48, width=64, max_shift=1.2)
    flow0 = (rng.random((2, 48, 64, 2)) * 0.4 - 0.2).astype(np.float32)
    cfg = LKConfig(bounded_warp=2, bf16=bf16)
    ref_fn = jax.jit(
        jax.vmap(lambda g, fl: jlk.lk_refine(jnp.asarray(burst[0]), g, fl, cfg))
    )
    want = nn(ref_fn(jnp.asarray(burst[1:]), jnp.asarray(flow0)))
    got = nn(lucas_kanade.lk_refine(tt(burst[0]), tt(burst[1:]), tt(flow0), cfg))
    assert np.abs(want - flow0).max() > 0.1  # the refinement moved
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.mean(np.abs(got - want) < 1e-4) > 0.99


def test_lk_refine_rejects_gather_warp(rng):
    x = tt(rng.random((8, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="bounded"):
        lucas_kanade.lk_refine(x, x[None], x.new_zeros((1, 8, 8, 2)), LKConfig())


def test_robustness_mask(rng):
    ref = rng.random((24, 32, 3)).astype(np.float32)
    moved = np.clip(ref + rng.standard_normal((2, 24, 32, 3)) * 0.02, 0, 1).astype(np.float32)
    moved[1, 8:16, 8:20] = rng.random((8, 12, 3))  # a moving object
    flow = (rng.random((2, 24, 32, 2)) * 2.0 - 1.0).astype(np.float32)
    cfg = dataclasses.replace(RobustnessConfig(), threshold_m=0.05)
    want = np.stack([
        nn(jrobust(jnp.asarray(ref), jnp.asarray(m), jnp.asarray(f), cfg, bounded=2))
        for m, f in zip(moved, flow)
    ])
    got = nn(robustness_mask(tt(ref), tt(moved), tt(flow), cfg, bounded=2))
    assert 0.0 < want[..., :3].mean() < 1.0 and (want[..., 3] > 0.05).any()
    np.testing.assert_allclose(got, want, atol=2e-5)
