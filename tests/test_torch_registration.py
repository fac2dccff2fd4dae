"""Parity of the PyTorch port's registration stages with the JAX package:
SSD surfaces, argmin, the per-level tile search of both branches, the
tile pyramid, Lucas-Kanade and robustness, on the same numpy inputs."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import (
    BIG_SHIFTS,
    SMALL_SHIFTS,
    nn,
    prealigned_search_inputs,
    search_inputs,
    tied_minima,
    to_jax,
    tt,
)

from multi_frame_super_resolution_tpu.models.robustness import robustness_mask as jrobust
from multi_frame_super_resolution_tpu.registration import align as jalign
from multi_frame_super_resolution_tpu.registration import lucas_kanade as jlk
from multi_frame_super_resolution_tpu.registration import subpixel as jsub
from multi_frame_super_resolution_tpu.registration import tiles as jtiles
from multi_frame_super_resolution_tpu_torch.config import AlignConfig, LKConfig, RobustnessConfig
from multi_frame_super_resolution_tpu_torch.data import synthetic_burst
from multi_frame_super_resolution_tpu_torch.models.robustness import robustness_mask
from multi_frame_super_resolution_tpu_torch.registration import (
    align,
    lucas_kanade,
    subpixel,
    tiles,
)

jwarp = importlib.import_module("multi_frame_super_resolution_tpu.ops.warp_fast")


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


def jax_tile_search(ref, alts, rounded, t, radius, threshold, sub, mode):
    """The JAX package's per-level composition of align_frames, frame by
    frame: tile_warp_select + ssd_surface_image (fast branch) or
    extract_search_windows + ssd_surface (windows branch), then
    find_min_shift; rounded + the found shift."""
    out = []
    for alt, pre in zip(alts, rounded):
        if mode == "image":
            warped = jwarp.tile_warp_select(jnp.asarray(alt), jnp.asarray(pre).astype(jnp.int32), t)
            ssd = jtiles.ssd_surface_image(jnp.asarray(ref), warped, t, radius)
        else:
            windows = jtiles.extract_search_windows(jnp.asarray(alt), t, radius, jnp.asarray(pre))
            ssd = jtiles.ssd_surface(jtiles.extract_ref_tiles(jnp.asarray(ref), t), windows, radius)
        out.append(pre + nn(jtiles.find_min_shift(ssd, radius, threshold, sub)))
    return np.stack(out)


@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize("mode,radius", [("image", 4), ("tile", 4), ("tile", 9)])
@pytest.mark.parametrize("h,w", [(128, 256), (72, 100)])
def test_tile_search_matches_jax_composition(h, w, mode, radius, threshold, sub):
    """The plain tile search (the kernel's plain version) against the JAX
    per-level composition on a burst-like input. Without the subpixel
    step the shifts are integers and must be equal on every tile; with it
    they agree within 1e-3 px (the f32 rounding of the SSD sums, which the
    quadratic fit amplifies). Tiles whose minimum is an exact tie are
    ranked by rounding in both and left out: on this input, tiles of the
    ragged last column (4 real columns, edge-padded in the reference tile
    and clamped in the window)."""
    ref, alts, rounded = search_inputs(h, w, BIG_SHIFTS if mode == "image" else SMALL_SHIFTS)
    got = nn(tiles.tile_search(tt(ref), tt(alts), tt(rounded), 16, radius, threshold, sub, mode))
    want = jax_tile_search(ref, alts, rounded, 16, radius, threshold, sub, mode)
    assert got.shape == want.shape == rounded.shape
    assert (np.abs(want - rounded) > 0.5).any()  # the search moved
    untied = ~tied_minima(ref, alts, rounded, 16, radius) if mode == "tile" else np.ones(rounded.shape[:3], bool)
    assert untied[..., :-1].all()
    if sub:
        np.testing.assert_allclose(got[untied], want[untied], rtol=0, atol=1e-3)
    else:
        np.testing.assert_array_equal(got[untied], want[untied])


def test_tile_search_matches_jax_on_prealigned_rotations():
    """RAW_SCALE4's two searches (T = 8, R = 4, "image" mode) on a 9-frame
    burst rotated 5-15 degrees and pre-aligned by the port: some surfaces
    are flat along one axis below float32 rounding (rows that
    pre-alignment clamped to the frame's edge), so their argmin is ranked
    by each implementation's rounding. Outside tiles.float32_undecided's
    argmin mask the plain search's integer parts equal the JAX
    composition's; outside both masks the subpixel shifts agree within
    1e-3 px."""
    levels = prealigned_search_inputs()
    assert [tuple(c[1].shape) for c in levels] == [(8, 32, 64), (8, 64, 128)]
    for ref, alts, rounded, t, radius, threshold in levels:
        undecided, ill = (nn(m) for m in tiles.float32_undecided(ref, alts, rounded, t, radius, threshold))
        for sub in (False, True):
            got = nn(tiles.tile_search(ref, alts, rounded, t, radius, threshold, sub, "image"))
            want = jax_tile_search(*(nn(x) for x in (ref, alts, rounded)), t, radius, threshold, sub, "image")
            if sub:
                keep = ~undecided & ~ill
                np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-3)
            else:
                np.testing.assert_array_equal(got[~undecided], want[~undecided])
    assert undecided.sum() >= 10  # the fine level has such tiles


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
    want = nn(jax.jit(jalign.align_burst, static_argnums=1)(jnp.asarray(gray), to_jax(cfg)))
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
        jax.vmap(lambda g, fl: jlk.lk_refine(jnp.asarray(burst[0]), g, fl, to_jax(cfg)))
    )
    want = nn(ref_fn(jnp.asarray(burst[1:]), jnp.asarray(flow0)))
    got = nn(lucas_kanade.lk_refine(tt(burst[0]), tt(burst[1:]), tt(flow0), cfg))
    assert np.abs(want - flow0).max() > 0.1  # the refinement moved
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.mean(np.abs(got - want) < 1e-4) > 0.99


def test_lk_refine_default_gather_warp_matches_jax(rng):
    """LKConfig() (no bounded warp, no tile decomposition) selects the
    bilinear gather warp; lk_refine rejected it until it was ported. At
    the defaults, on a ragged 21 x 27 pair with flows of up to +-4 px, a
    reference (H, W) broadcast against two moving frames: the flows are
    not clamped (a 2 px bounded warp gives others) and agree with the
    jitted JAX function within the bf16 window sums' tolerance of
    test_lk_refine (test_torch_flow.py holds the branch at set fields)."""
    x = rng.random((3, 21, 27)).astype(np.float32)
    flow0 = (rng.random((2, 21, 27, 2)) * 8.0 - 4.0).astype(np.float32)
    ref_fn = jax.jit(jax.vmap(lambda g, fl: jlk.lk_refine(jnp.asarray(x[0]), g, fl)))
    want = nn(ref_fn(jnp.asarray(x[1:]), jnp.asarray(flow0)))
    got = nn(lucas_kanade.lk_refine(tt(x[0]), tt(x[1:]), tt(flow0), LKConfig()))
    bounded = nn(lucas_kanade.lk_refine(tt(x[0]), tt(x[1:]), tt(flow0), LKConfig(bounded_warp=2)))
    assert np.abs(bounded - got).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_robustness_mask(rng):
    ref = rng.random((24, 32, 3)).astype(np.float32)
    moved = np.clip(ref + rng.standard_normal((2, 24, 32, 3)) * 0.02, 0, 1).astype(np.float32)
    moved[1, 8:16, 8:20] = rng.random((8, 12, 3))  # a moving object
    flow = (rng.random((2, 24, 32, 2)) * 2.0 - 1.0).astype(np.float32)
    cfg = dataclasses.replace(RobustnessConfig(), threshold_m=0.05)
    want = np.stack([
        nn(jrobust(jnp.asarray(ref), jnp.asarray(m), jnp.asarray(f), to_jax(cfg), bounded=2))
        for m, f in zip(moved, flow)
    ])
    got = nn(robustness_mask(tt(ref), tt(moved), tt(flow), cfg, bounded=2))
    assert 0.0 < want[..., :3].mean() < 1.0 and (want[..., 3] > 0.05).any()
    np.testing.assert_allclose(got, want, atol=2e-5)
