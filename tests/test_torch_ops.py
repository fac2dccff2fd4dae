"""Parity of the PyTorch port's image ops with the JAX package: the same
numpy input through both, compared at a stated tolerance. Tolerances of
1e-6 absolute cover f32 sums taken in another order on [0, 1] data;
gathers, selects and shifts are exact."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.ops import color as jcolor
from multi_frame_super_resolution_tpu.ops import filters as jfilters
from multi_frame_super_resolution_tpu.ops import geometry as jgeo
from multi_frame_super_resolution_tpu.ops import morphology as jmorph
from multi_frame_super_resolution_tpu.ops import warp_fast as jwarp
from multi_frame_super_resolution_tpu_torch.ops import color, derivatives, filters
from multi_frame_super_resolution_tpu_torch.ops import geometry, morphology, warp_fast

# the JAX ops package re-exports a function named `derivatives`
jder = importlib.import_module("multi_frame_super_resolution_tpu.ops.derivatives")


def test_synthetic_bursts_match_jax_generator():
    from multi_frame_super_resolution_tpu.data.datasets import synthetic_burst as jburst
    from multi_frame_super_resolution_tpu_torch.data import (
        synthetic_burst,
        synthetic_rgb_burst,
    )

    a, sa = jburst(np.random.default_rng(3), 3, 24, 40, 2.0, 0.05)
    b, sb = synthetic_burst(np.random.default_rng(3), 3, 24, 40, 2.0, 0.05)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sa, sb)
    rgb, shifts = synthetic_rgb_burst(np.random.default_rng(3), 3, 24, 40, 2.0)
    assert rgb.shape == (3, 24, 40, 3) and rgb.dtype == np.float32
    assert 0.0 <= rgb.min() and rgb.max() <= 1.0
    assert np.all(shifts[0] == 0.0) and np.any(shifts[1:] != 0.0)


def test_color(rng):
    img = rng.random((2, 12, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        nn(color.rgb_to_gray(tt(img))), nn(jcolor.rgb_to_gray(jnp.asarray(img))),
        atol=1e-6,
    )
    img[0, 0, 0] = np.nan
    np.testing.assert_allclose(
        nn(color.srgb_gamma(tt(img))), nn(jcolor.srgb_gamma(jnp.asarray(img))),
        atol=1e-6,
    )


@pytest.mark.parametrize(
    "size,normalize,h,w",
    [(3, True, 20, 28), (5, False, 9, 13), (17, False, 24, 40), (17, True, 16, 1030)],
)
def test_box_filter_planes_f32(rng, size, normalize, h, w):
    """Direct window sums (size <= 7) and the edge-padded cumsum form
    (wide windows, or edges past the banded-matmul limit). The cumsum
    form cancels in f32 at ~1e-5 of the running sum (ops/filters.py notes)."""
    x = rng.random((2, h, w)).astype(np.float32)
    got = nn(filters.box_filter_planes(tt(x), size, normalize))
    want = nn(jfilters.box_filter_planes(jnp.asarray(x), size, normalize))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_box_filter_planes_bf16_roundings(rng):
    """LKConfig.bf16's window sums: bf16 input, f32 column sums, bf16
    partial sums, f32 row sums. The port reproduces both roundings; sums
    in another f32 order can flip a partial sum's bf16 rounding, so allow
    one bf16 step (2^-8 relative) where that happens. A port that skipped
    the roundings misses by far more."""
    x = (rng.standard_normal((3, 40, 56)) * 0.05).astype(np.float32)
    want = nn(jfilters.box_filter_planes(jnp.asarray(x), 17, False, mxu_bf16=True))
    got = nn(filters.box_filter_planes(tt(x), 17, False, mxu_bf16=True))
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 2.0**-8 * scale
    assert np.mean(err <= 1e-6 * scale) > 0.95  # nearly all bit-for-bit
    f32 = nn(filters.box_filter_planes(tt(x), 17, False, mxu_bf16=False))
    assert np.abs(f32 - want).max() > 20 * err.max()


def test_box_filter_channel_last(rng):
    img = rng.random((2, 10, 14, 3)).astype(np.float32)
    got = nn(filters.box_filter(tt(img), 3))
    want = np.stack([nn(jfilters.box_filter(jnp.asarray(i), 3)) for i in img])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_derivatives_and_structure_tensor(rng):
    a = rng.random((18, 22)).astype(np.float32)
    b = rng.random((18, 22)).astype(np.float32)
    for got, want in zip(
        derivatives.derivatives_pair(tt(a), tt(b)),
        jder.derivatives_pair(jnp.asarray(a), jnp.asarray(b)),
    ):
        np.testing.assert_allclose(nn(got), nn(want), atol=1e-6)
    dx, dy = derivatives.derivatives(tt(a))
    jdx, jdy = jder.derivatives(jnp.asarray(a))
    np.testing.assert_allclose(
        nn(derivatives.structure_tensor(dx, dy)), nn(jder.structure_tensor(jdx, jdy)),
        atol=1e-6,
    )
    ky = np.asarray([0.25, 0.5, 0.25], np.float32)
    kx = np.asarray([1.0, 2.0, 0.0, -1.0, 0.5], np.float32)
    np.testing.assert_allclose(
        nn(filters.separable_filter(tt(a), ky, kx)),
        nn(jfilters.separable_filter(jnp.asarray(a), jnp.asarray(ky), jnp.asarray(kx))),
        atol=1e-6,
    )


def test_downsample2_and_resize(rng):
    x = rng.random((3, 17, 26)).astype(np.float32)
    want = np.stack([nn(jgeo.downsample2(jnp.asarray(p))) for p in x])
    np.testing.assert_allclose(nn(geometry.downsample2(tt(x))), want, atol=1e-7)
    img = rng.random((5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        nn(geometry.resize(tt(img), 23, 19)),
        nn(jgeo.resize(jnp.asarray(img), 23, 19, "bilinear")),
        atol=1e-6,
    )


def test_morphology_exact(rng):
    x = rng.standard_normal((2, 11, 15)).astype(np.float32)
    for port, ref in ((morphology.erode, jmorph.erode), (morphology.dilate, jmorph.dilate)):
        want = np.stack([nn(ref(jnp.asarray(p), 5)) for p in x])
        np.testing.assert_array_equal(nn(port(tt(x), 5)), want)


@pytest.mark.parametrize("s,method", [(2, "bicubic"), (3, "bilinear"), (16, "bilinear")])
def test_upsample_int(rng, s, method):
    img = rng.random((6, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        nn(warp_fast.upsample_int(tt(img), s, method)),
        nn(jwarp.upsample_int(jnp.asarray(img), s, method)),
        atol=1e-6,
    )


def test_warp_bounded(rng):
    img = rng.random((3, 14, 18)).astype(np.float32)
    flow = (rng.random((14, 18, 2)) * 5.0 - 2.5).astype(np.float32)
    want = np.stack([nn(jwarp.warp_bounded(jnp.asarray(p), jnp.asarray(flow), 2)) for p in img])
    np.testing.assert_allclose(nn(warp_fast.warp_bounded(tt(img), tt(flow), 2)), want, atol=1e-6)


def test_tile_shift_decompose_rounds_half_to_even():
    s = np.asarray([[-2.5, -1.5, -0.5, 0.5], [1.5, 2.5, 0.49, -3.7]], np.float32)
    ints, res = warp_fast.tile_shift_decompose(tt(s))
    jints, jres = jwarp.tile_shift_decompose(jnp.asarray(s))
    np.testing.assert_array_equal(nn(ints), nn(jints))
    np.testing.assert_array_equal(nn(res), nn(jres))


@pytest.mark.parametrize("h,w,t,bound", [(64, 96, 16, 16), (40, 56, 16, 16), (32, 48, 8, 6)])
def test_tile_warp_select_exact(rng, h, w, t, bound):
    """The one-hot warp's function, including the two-level decomposition's
    tile-crossing bands at bound 16 (shifts up to +-bound)."""
    img = rng.random((h, w)).astype(np.float32)
    shifts = rng.integers(-bound, bound + 1, (-(-h // t), -(-w // t), 2)).astype(np.int32)
    want = nn(jwarp.tile_warp_select(jnp.asarray(img), jnp.asarray(shifts), t, bound=bound))
    got = nn(warp_fast.tile_warp_select(tt(img)[None], tt(shifts)[None], t, bound)[0])
    np.testing.assert_array_equal(got, want)
    if 2 * bound + 1 > 13:
        # the naive per-pixel shift is a different function here
        naive = nn(jwarp.tile_warp_int(jnp.asarray(img), jnp.asarray(shifts), t))
        assert np.any(naive != want)


@pytest.mark.parametrize("h,w,t", [(64, 96, 32), (40, 56, 16)])
def test_tile_warp_matmul_exact(rng, h, w, t):
    """The selector-matmul warp takes the y-shift from the source column's
    tile; the port's single gather reproduces it exactly."""
    imgs = rng.random((2, 3, h, w)).astype(np.float32)
    shifts = rng.integers(-16, 17, (2, -(-h // t), -(-w // t), 2)).astype(np.int32)
    want = np.stack([
        nn(jwarp.tile_warp_matmul(jnp.asarray(i), jnp.asarray(s), t, precision="highest"))
        for i, s in zip(imgs, shifts)
    ])
    got = nn(warp_fast.tile_warp_matmul(tt(imgs), tt(shifts), t))
    np.testing.assert_array_equal(got, want)
