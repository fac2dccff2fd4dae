"""The port's public surface at the JAX call forms: every function that
takes the name of a JAX function takes that function's array forms,
(H, W) and (H, W, C) images or two (H, W) images, and returns its shapes
and values; its parameters come in JAX's order with JAX's defaults; and
every public name of the JAX package resolves in the port, by module and
through the packages' re-exports.

Each case feeds the same numpy input, from ``np.random.default_rng``, to
the jitted JAX function and to the port's, at 64 x 96 or smaller, and
compares at atol 1e-5 (rtol 0), or exactly where the port is exact. The
pipelines' own layouts have their own names (``_planes``, ``_batched``);
their tests are in the other tests/test_torch_*.py files.
"""

import ast
import importlib
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfast_merge
from multi_frame_super_resolution_tpu.models import robustness as jrobustness
from multi_frame_super_resolution_tpu.ops import filters as jfilters
from multi_frame_super_resolution_tpu.ops import fourier as jfourier
from multi_frame_super_resolution_tpu.ops import geometry as jgeometry
from multi_frame_super_resolution_tpu.ops import morphology as jmorphology
from multi_frame_super_resolution_tpu.ops import restore as jrestore
from multi_frame_super_resolution_tpu.ops import warp_fast as jwarp
from multi_frame_super_resolution_tpu.registration import align as jalign
from multi_frame_super_resolution_tpu.registration import logpolar as jlogpolar
from multi_frame_super_resolution_tpu.registration import phase_correlation as jpc
from multi_frame_super_resolution_tpu.registration import subpixel as jsubpixel
from multi_frame_super_resolution_tpu.registration import tiles as jtiles
from multi_frame_super_resolution_tpu_torch.config import PREALIGN_FAST, RegistrationConfig
from multi_frame_super_resolution_tpu_torch.data import synthetic_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models import fast_merge, robustness
from multi_frame_super_resolution_tpu_torch.ops import filters, geometry, morphology, restore, warp_fast
from multi_frame_super_resolution_tpu_torch.registration import align, logpolar, phase_correlation, subpixel, tiles

# both ops packages re-export a function named `derivatives`
jderivatives = importlib.import_module("multi_frame_super_resolution_tpu.ops.derivatives")
derivatives = importlib.import_module("multi_frame_super_resolution_tpu_torch.ops.derivatives")

TOL = dict(rtol=0, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "multi_frame_super_resolution_tpu"
PORT_PKG = ROOT / "multi_frame_super_resolution_tpu_torch"

# the TPU-only formulations the port does not carry (ROADMAP.md "Do not
# port"): it computes their functions in the direct form a GPU favours
DO_NOT_PORT = {
    "tile_warp_select", "tile_warp_matmul", "interleave_phases_planes_mxu",
    "pool_cols_mxu", "remap_static", "static_sep_weights", "interpret_pallas",
}
FORMS = ["hw", "hwc"]


def _image(form, seed=0, h=32, w=48, c=3):
    rng = np.random.default_rng(seed)
    shape = (h, w) if form == "hw" else (h, w, c)
    return rng.random(shape).astype(np.float32)


def _close(got, want, exact=False):
    got, want = nn(got), nn(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def _jit(fn, *arrays):
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrays))


# ---- ops/filters.py ----------------------------------------------------------

@pytest.mark.parametrize("sigma", [0.7, 1.3, 3.7])
@pytest.mark.parametrize("form", FORMS)
def test_gaussian_blur_jax_forms(form, sigma):
    """(H, W, C) is blurred over H and W: on 32 x 48 x 3 from
    default_rng(2) at sigma 1.3 the (W, C) blur differed by 0.296."""
    img = _image(form, seed=2)
    want = _jit(lambda x: jfilters.gaussian_blur(x, sigma), img)
    _close(filters.gaussian_blur(tt(img), sigma), want)


@pytest.mark.parametrize("border", ["replicate", "zero"])
@pytest.mark.parametrize("form", FORMS)
def test_separable_filter_jax_forms(form, border):
    img = _image(form, seed=3)
    rng = np.random.default_rng(4)
    ky, kx = rng.random(5).astype(np.float32), rng.random(3).astype(np.float32)
    want = _jit(lambda x: jfilters.separable_filter(x, jnp.asarray(ky), jnp.asarray(kx), border), img)
    _close(filters.separable_filter(tt(img), ky, kx, border), want)
    # the JAX default border is replicate, its own order positional
    if border == "replicate":
        _close(filters.separable_filter(tt(img), ky, kx), want)


@pytest.mark.parametrize("size", [3, 9])
@pytest.mark.parametrize("form", FORMS)
def test_box_filter_jax_forms(form, size):
    """(H, W) raised IndexError; both branches of the JAX function (window
    sums to 7, cumsum differences past it)."""
    img = _image(form, seed=5)
    for normalize in (True, False):
        want = _jit(lambda x: jfilters.box_filter(x, size, normalize), img)
        got = filters.box_filter(tt(img), size, normalize)
        np.testing.assert_allclose(nn(got), nn(want), rtol=1e-6 if not normalize else 0, atol=1e-5)


def test_box_filter_constant_image():
    """JAX's tests/test_ops_filters.py::test_box_filter_constant_image."""
    out = filters.box_filter(torch.ones((16, 16)), 5)
    np.testing.assert_allclose(nn(out), 1.0, atol=1e-6)
    _close(out, jfilters.box_filter(jnp.ones((16, 16)), 5))


def test_multichannel_filters():
    """JAX's tests/test_ops_filters.py::test_multichannel_filters, values
    held against JAX too."""
    img = np.random.default_rng(0).random((16, 16, 3)).astype(np.float32)
    blurred = filters.gaussian_blur(tt(img), 1.0)
    sharp = filters.laplacian_sharpen(tt(img))
    assert blurred.shape == sharp.shape == img.shape
    _close(blurred, _jit(lambda x: jfilters.gaussian_blur(x, 1.0), img))
    _close(sharp, _jit(jfilters.laplacian_sharpen, img))


@pytest.mark.parametrize("border", ["replicate", "zero"])
@pytest.mark.parametrize("form", FORMS + ["nhwc"])
def test_conv2d_jax_forms(form, border):
    img = _image("hwc" if form == "nhwc" else form, seed=6)
    if form == "nhwc":
        img = np.stack([img, img[::-1]])
    kernel = np.random.default_rng(7).standard_normal((3, 5)).astype(np.float32)
    want = _jit(lambda x: jfilters.conv2d(x, jnp.asarray(kernel), border), img)
    _close(filters.conv2d(tt(img), kernel, border), want)


@pytest.mark.parametrize("name,planes_name", [
    ("gaussian_blur", "gaussian_blur_planes"), ("separable_filter", "separable_filter_planes"),
])
def test_filters_refuse_other_ranks_naming_planes(name, planes_name):
    args = {"gaussian_blur": (1.0,), "separable_filter": (np.ones(3, np.float32), np.ones(3, np.float32))}[name]
    with pytest.raises(ValueError, match=planes_name):
        getattr(filters, name)(torch.zeros((2, 3, 8, 8)), *args)


# ---- ops/derivatives.py, ops/morphology.py -----------------------------------

@pytest.mark.parametrize("name", ["derivative5_x", "derivative5_y", "derivatives", "derivatives_pair"])
@pytest.mark.parametrize("form", FORMS)
def test_derivatives_jax_forms(form, name):
    a, b = _image(form, seed=8), _image(form, seed=9)
    args = (a, b) if name == "derivatives_pair" else (a,)
    want = _jit(getattr(jderivatives, name), *args)
    got = getattr(derivatives, name)(*map(tt, args))
    for g, w_ in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        _close(g, w_)


@pytest.mark.parametrize("name", ["dilate", "erode"])
@pytest.mark.parametrize("form", FORMS)
def test_morphology_jax_forms(form, name):
    """Min and max select values: exact."""
    img = _image(form, seed=10)
    want = _jit(lambda x: getattr(jmorphology, name)(x, 3), img)
    _close(getattr(morphology, name)(tt(img), 3), want, exact=True)


# ---- ops/geometry.py ---------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_downsample2_jax_forms(form):
    """(H, W, C) gave (32, 24, 1) for (16, 24, 3)."""
    img = _image(form, seed=11, h=33, w=48)
    got = geometry.downsample2(tt(img))
    want = _jit(jgeometry.downsample2, img)
    _close(got, want)
    assert got.shape[:2] == (16, 24)


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("form", FORMS)
def test_resize_jax_forms(form, method):
    img = _image(form, seed=12, h=20, w=28)
    want = _jit(lambda x: jgeometry.resize(x, 31, 17, method), img)
    _close(geometry.resize(tt(img), 31, 17, method), want)


@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("form", FORMS)
def test_upscale_jax_forms(form, scale):
    img = _image(form, seed=13, h=16, w=24)
    want = _jit(lambda x: jgeometry.upscale(x, scale), img)
    _close(geometry.upscale(tt(img), scale), want)


def test_resize_downsample_consistency():
    """JAX's tests/test_ops_geometry.py::test_resize_downsample_consistency
    on (H, W): the half-size bilinear resize is the 2 x 2 mean."""
    rng = np.random.default_rng(14)
    img = filters.gaussian_blur(tt(rng.random((32, 32)).astype(np.float32)), 1.5)
    small = geometry.resize(img, 16, 16, "bilinear")
    np.testing.assert_allclose(nn(small), nn(geometry.downsample2(img)), atol=1e-5)
    _close(small, _jit(lambda x: jgeometry.resize(x, 16, 16, "bilinear"), nn(img)))


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("form", FORMS)
def test_warp_backward_jax_forms(form, method):
    """(H, W, C) raised RuntimeError."""
    img = _image(form, seed=15)
    flow = (np.random.default_rng(16).standard_normal((32, 48, 2)) * 3.0).astype(np.float32)
    want = _jit(lambda x, f: jgeometry.warp_backward(x, f, method), img, flow)
    _close(geometry.warp_backward(tt(img), tt(flow), method), want)


@pytest.mark.parametrize("name", ["remap_bilinear", "remap_bicubic"])
@pytest.mark.parametrize("form", FORMS)
def test_remap_jax_forms(form, name):
    """A grid (Ho, Wo) and a 1-D list of points: the output has the
    coordinates' shape (+ C)."""
    img = _image(form, seed=17)
    rng = np.random.default_rng(18)
    for shape in ((20, 30), (50,)):
        ys = (rng.random(shape) * 40.0 - 4.0).astype(np.float32)
        xs = (rng.random(shape) * 56.0 - 4.0).astype(np.float32)
        want = _jit(getattr(jgeometry, name), img, ys, xs)
        _close(getattr(geometry, name)(tt(img), tt(ys), tt(xs)), want)


def test_identity_grid_takes_the_dtype_third():
    ys, xs = geometry.identity_grid(4, 5, torch.float64)
    jys, jxs = jgeometry.identity_grid(4, 5, jnp.float32)
    assert ys.dtype == torch.float64
    _close(ys.float(), jys, exact=True)
    _close(xs.float(), jxs, exact=True)


# ---- ops/warp_fast.py --------------------------------------------------------

@pytest.mark.parametrize("s,method", [(2, "bilinear"), (3, "bicubic")])
@pytest.mark.parametrize("form", FORMS)
def test_upsample_int_jax_forms(form, s, method):
    """(H, W) raised RuntimeError."""
    img = _image(form, seed=19, h=12, w=20)
    want = _jit(lambda x: jwarp.upsample_int(x, s, method), img)
    _close(warp_fast.upsample_int(tt(img), s, method), want)


@pytest.mark.parametrize("form", FORMS)
def test_upsample_phases_and_interleave_jax_forms(form):
    img = _image(form, seed=20, h=12, w=20)
    for s, method in ((1, "bilinear"), (2, "bilinear"), (3, "bicubic")):
        want = _jit(lambda x: jwarp.upsample_int_phases(x, s, method), img)
        got = warp_fast.upsample_int_phases(tt(img), s, method)
        _close(got, want)
        _close(warp_fast.interleave_phases(tt(np.array(want))), _jit(jwarp.interleave_phases, nn(want)), exact=True)
    _close(warp_fast.upsample_nearest(tt(img), 3), _jit(lambda x: jwarp.upsample_nearest(x, 3), img), exact=True)


@pytest.mark.parametrize("form", FORMS)
def test_warp_bounded_jax_forms(form):
    """(H, W, C) raised RuntimeError."""
    img = _image(form, seed=21)
    flow = (np.random.default_rng(22).random((32, 48, 2)) * 5.0 - 2.5).astype(np.float32)
    want = _jit(lambda x, f: jwarp.warp_bounded(x, f, 2), img, flow)
    _close(warp_fast.warp_bounded(tt(img), tt(flow), 2), want)


@pytest.mark.parametrize("t,amp", [(16, 3), (16, 40), (12, 7), (8, 100)])
@pytest.mark.parametrize("form", FORMS)
def test_tile_warp_int_jax_forms(form, t, amp):
    """The per-pixel clamped per-tile shift, through the tile-warp
    wrapper's block map on an edge-padded image (its plain version here):
    ragged tile grids, shifts past the tiles and past the image; exact."""
    img = _image(form, seed=23, h=40, w=61)
    rng = np.random.default_rng(amp)
    shifts = rng.integers(-amp, amp + 1, (-(-40 // t), -(-61 // t), 2)).astype(np.int32)
    want = _jit(lambda x, s: jwarp.tile_warp_int(x, s, t), img, shifts)
    LAUNCHES.clear()
    _close(warp_fast.tile_warp_int(tt(img), tt(shifts), t), want, exact=True)
    assert not LAUNCHES  # CPU tensors take the plain version


@pytest.mark.parametrize("form", FORMS)
def test_warp_decomposed_jax_forms(form):
    img = _image(form, seed=24)
    rng = np.random.default_rng(25)
    ints = rng.integers(-5, 6, (2, 3, 2)).astype(np.int32)
    res = (rng.random((32, 48, 2)) * 3.0 - 1.5).astype(np.float32)
    want = _jit(lambda x, i, r: jwarp.warp_decomposed(x, i, r, 16), img, ints, res)
    _close(warp_fast.warp_decomposed(tt(img), tt(ints), tt(res), 16), want)


def test_similarity_warp_fast_takes_batch_dims():
    """JAX's channel-leading planes (C, H, W) sharing one (H, W) grid,
    batch_dims=1."""
    img = np.moveaxis(_image("hwc", seed=26), -1, 0).copy()
    ys, xs = (g.numpy() for g in geometry.identity_grid(32, 48))
    a = math.radians(4.0)
    src_y = (np.sin(a) * (xs - 23.5) + np.cos(a) * (ys - 15.5) + 15.5 + 0.7).astype(np.float32)
    src_x = (np.cos(a) * (xs - 23.5) - np.sin(a) * (ys - 15.5) + 23.5 - 1.2).astype(np.float32)
    want = _jit(lambda x, y, z: jwarp.similarity_warp_fast(x, y, z, None, 1), img, src_y, src_x)
    _close(warp_fast.similarity_warp_fast(tt(img), tt(src_y), tt(src_x), None, 1), want)


# ---- ops/restore.py ----------------------------------------------------------

@pytest.mark.parametrize("gain", [None, 0.6])
@pytest.mark.parametrize("form", FORMS)
def test_restore_image_takes_the_kernel_second(form, gain):
    """restore_image(img, k) applies k as the FIR, as JAX's does; it once
    took the gain there."""
    img = _image(form, seed=27)
    k = np.random.default_rng(28).standard_normal((5, 5)).astype(np.float32) * 0.1
    k[2, 2] += 1.0
    g = None if gain is None else jnp.float32(gain)
    want = jax.jit(lambda x: jrestore.restore_image(x, k, g))(jnp.asarray(img))
    got = restore.restore_image(tt(img), k, None if gain is None else torch.tensor(gain))
    _close(got, want)
    # the default kernel by keyword, and by position None
    _close(restore.restore_image(tt(img), None), jax.jit(jrestore.restore_image)(jnp.asarray(img)))


@pytest.mark.parametrize("n,gain", [(2, None), (3, 0.6)])
def test_restore_phases_takes_a_kernel(n, gain):
    planes = np.random.default_rng(29).random((n, n, 3, 10, 14)).astype(np.float32)
    k = np.random.default_rng(30).standard_normal((7, 7)).astype(np.float32) * 0.05
    k[3, 3] += 1.0
    g = None if gain is None else jnp.float32(gain)
    want = jax.jit(lambda p: jrestore.restore_phases(p, k, g))(jnp.asarray(planes))
    _close(restore.restore_phases(tt(planes), k, None if gain is None else torch.tensor(gain)), want)


def test_temporal_noise_stat_takes_flows_second():
    rng = np.random.default_rng(31)
    gray, _ = synthetic_burst(rng, 3, 48, 64, 1.5)
    gray = (gray + 0.01 * rng.standard_normal(gray.shape)).astype(np.float32)
    flows = (rng.random((3, 48, 64, 2)) * 3.0 - 1.5).astype(np.float32)
    want = float(jax.jit(jrestore.temporal_noise_stat)(jnp.asarray(gray), jnp.asarray(flows)))
    np.testing.assert_allclose(float(restore.temporal_noise_stat(tt(gray), tt(flows))), want, rtol=1e-5)


# ---- registration ------------------------------------------------------------

def _pair(h=64, w=64, seed=32):
    rng = np.random.default_rng(seed)
    burst, _ = synthetic_burst(rng, 2, h, w, 2.0)
    return burst[0], burst[1]


@pytest.mark.parametrize("refine", [0, 16])
def test_phase_correlate_two_images(refine):
    """Two (H, W) images raised ValueError; JAX's tests/
    test_registration.py:57 (a circular shift, integer peak) and a
    windowed, refined pair. The refined peak sits on the 1/16 grid; its
    position moves by one cell on float32 rounding."""
    a, b = _pair()
    moved = np.roll(a, (-4, 7), axis=(0, 1))
    shift, peak = phase_correlation.phase_correlate(tt(a), tt(moved), subpixel=False)
    assert shift.shape == (2,) and peak.ndim == 0
    np.testing.assert_allclose(nn(shift), [4.0, -7.0], atol=0.01)
    assert float(peak) > 0.5
    win = jfourier.apodization_window(64, 64, 7)
    want_s, want_p = jax.jit(lambda x, y: jpc.phase_correlate(x, y, window=jnp.asarray(win), refine=refine))(a, b)
    got_s, got_p = phase_correlation.phase_correlate(tt(a), tt(b), window=tt(win), refine=refine)
    np.testing.assert_allclose(nn(got_s), nn(want_s), atol=1.0 / 16 if refine else 1e-4)
    np.testing.assert_allclose(float(got_p), float(want_p), atol=2e-3)


@pytest.mark.parametrize("cfg", [RegistrationConfig(), PREALIGN_FAST], ids=["default", "prealign_fast"])
def test_register_two_images(cfg):
    """register_translation, register_rotation_scale and
    register_similarity on two (H, W) images (a 5-degree rotation):
    scalar results, within a refine cell of the jitted JAX functions."""
    a, _ = _pair(seed=33)
    b = nn(geometry.rotate(tt(a), math.radians(5.0), "bilinear"))
    jcfg = to_jax(cfg)
    cell = math.pi / 63 / max(cfg.peak_upsample, 1)
    rot, scale, resp = logpolar.register_rotation_scale(tt(a), tt(b), cfg)
    jrot, jscale, _ = jax.jit(lambda x, y: jlogpolar.register_rotation_scale(x, y, jcfg))(a, b)
    assert rot.ndim == scale.ndim == resp.ndim == 0
    np.testing.assert_allclose(float(rot), float(jrot), atol=cell)
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-3)
    shift, _ = logpolar.register_translation(tt(a), tt(b), cfg)
    jshift, _ = jax.jit(lambda x, y: jlogpolar.register_translation(x, y, jcfg))(a, b)
    assert shift.shape == (2,)
    np.testing.assert_allclose(nn(shift), nn(jshift), atol=1.0 / 16 + 1e-3)
    st = logpolar.register_similarity(tt(a), tt(b), cfg)
    jst = jax.jit(lambda x, y: jlogpolar.register_similarity(x, y, jcfg))(a, b)
    assert st.rotation.ndim == 0 and st.translation.shape == (2,)
    np.testing.assert_allclose(float(st.rotation), float(jst.rotation), atol=cell)
    np.testing.assert_allclose(nn(st.translation), nn(jst.translation), atol=1.0 / 16 + 1e-3)


@pytest.mark.parametrize("name", ["phase_correlate", "register_translation"])
def test_pair_forms_refuse_a_batch_naming_batched(name):
    module = phase_correlation if name == "phase_correlate" else logpolar
    with pytest.raises(ValueError, match=f"{name}_batched"):
        getattr(module, name)(torch.zeros((16, 16)), torch.zeros((2, 16, 16)))


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("hw", [(64, 96), (60, 90)])
def test_flow_from_tile_shifts_smooth(smooth, hw):
    """smooth=False is the piecewise-constant field; both on a tile
    multiple (the polyphase upsample) and off it (the resize)."""
    shifts = (np.random.default_rng(34).random((4, 6, 2)) * 8.0 - 4.0).astype(np.float32)
    want = _jit(lambda s: jalign.flow_from_tile_shifts(s, 16, *hw, smooth), shifts)
    got = align.flow_from_tile_shifts(tt(shifts), 16, *hw, smooth)
    _close(got, want, exact=not smooth)


@pytest.mark.parametrize("pre", ["none", "float"])
def test_extract_search_windows_one_image(pre):
    """One (H, W) image and an optional float pre-shift, rounded half to
    even as JAX rounds it; exact."""
    img = _image("hw", seed=35, h=40, w=61)
    shift = None
    if pre == "float":
        shift = (np.random.default_rng(36).integers(-12, 13, (3, 4, 2)) * 0.5).astype(np.float32)
    want = jtiles.extract_search_windows(jnp.asarray(img), 16, 4, None if shift is None else jnp.asarray(shift))
    got = tiles.extract_search_windows(tt(img), 16, 4, None if shift is None else tt(shift))
    _close(got, want, exact=True)


@pytest.mark.parametrize("pre", ["none", "int"])
def test_extract_search_windows_fast(pre):
    img = _image("hw", seed=37, h=40, w=61)
    ints = None
    if pre == "int":
        ints = np.random.default_rng(38).integers(-6, 7, (3, 4, 2)).astype(np.int32)
    want = jtiles.extract_search_windows_fast(jnp.asarray(img), 16, 4, None if ints is None else jnp.asarray(ints))
    got = tiles.extract_search_windows_fast(tt(img), 16, 4, None if ints is None else tt(ints))
    _close(got, want, exact=True)
    with pytest.raises(ValueError, match="search_radius"):
        tiles.extract_search_windows_fast(tt(img), 8, 5)


def test_quadratic_subpixel_max():
    patch = np.random.default_rng(39).random((5, 3, 3)).astype(np.float32)
    patch[:, 1, 1] += 1.0
    _close(subpixel.quadratic_subpixel_max(tt(patch)), jsubpixel.quadratic_subpixel_max(jnp.asarray(patch)))


# ---- models ------------------------------------------------------------------

def _raw_planes_inputs(rng, f, hh, hw):
    return (
        rng.random((f, 2, 2, hh, hw)).astype(np.float32),
        rng.normal(0.0, 0.4, (f, hh, hw, 2)).astype(np.float32),
        rng.random((f, hh, hw, 3)).astype(np.float32),
        (rng.random((hh, hw, 3)) * 0.5 + 0.5).astype(np.float32),
        (rng.random((hh, hw, 3)) * 0.5 + 0.4).astype(np.float32),
    )


@pytest.mark.parametrize("kw", [{}, {"order": 1}, {"order": 1, "moment_slots": 4}],
                         ids=["defaults", "order1", "order1-4slots"])
def test_merge_burst_raw_planes_jax_signature(kw):
    """JAX's parameters and defaults: order 0, 9 moment slots, the
    per-cell centroid (centroid_cert=True), and phase_output=False, each
    output interleaved to (2s hh, 2s hw, 3)."""
    rng = np.random.default_rng(40)
    f, hh, hw = 2, 6, 8
    ins = _raw_planes_inputs(rng, f, hh, hw)
    cfa = ((0, 1), (1, 2))
    kw = dict(kw, radius=1, prune_exp=1.5)
    want = jfast_merge.merge_burst_raw_planes(*map(jnp.asarray, ins), cfa, 1, **kw)
    got = fast_merge.merge_burst_raw_planes(*map(tt, ins), cfa, 1, **kw)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.shape == (2 * hh, 2 * hw, 3)
        _close(g, w_)


def test_merge_burst_fast_jax_positional_order():
    """(..., k_max, phase_output, bf16, order, prune_exp) by position, and
    JAX's default of 9 moment slots at order 1; moments of the exact
    solve at its tolerance in tests/test_torch_exact.py, 1e-4."""
    rng = np.random.default_rng(42)
    f, h, w = 2, 8, 10
    ins = (rng.random((f, h, w, 3)).astype(np.float32), rng.normal(0.0, 0.3, (f, h, w, 2)).astype(np.float32),
           rng.random((f, h, w, 3)).astype(np.float32), (rng.random((h, w, 3)) * 0.5 + 0.5).astype(np.float32))
    args = (2, 1, 1.0, 1.0, True, False, 1, 1.5)
    want = jfast_merge.merge_burst_fast(*map(jnp.asarray, ins), *args)
    got = fast_merge.merge_burst_fast(*map(tt, ins), *args)
    assert len(got) == len(want) == 9
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-4, atol=1e-4)


def test_robustness_mask_defaults_to_the_gather():
    """bounded defaults to 0, the per-pixel gather, as in JAX."""
    rng = np.random.default_rng(41)
    ref = rng.random((24, 32, 3)).astype(np.float32)
    moved = rng.random((24, 32, 3)).astype(np.float32)
    flow = (rng.random((24, 32, 2)) * 8.0 - 4.0).astype(np.float32)
    want = _jit(jrobustness.robustness_mask, ref, moved, flow)
    _close(robustness.robustness_mask(tt(ref), tt(moved), tt(flow)), want)


# ---- names ---------------------------------------------------------------------

def _jax_init_names(pkg):
    tree = ast.parse((JAX_PKG / pkg / "__init__.py").read_text())
    return sorted(a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names)


def _jax_modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG)
        if rel.parts[0] == "pallas_ops" or rel.name == "__init__.py":
            continue  # the Pallas kernels are csrc/'s
        yield ".".join(rel.with_suffix("").parts)


@pytest.mark.parametrize("pkg", ["ops", "models", "registration"])
def test_package_reexports_match_jax(pkg):
    """Each name the JAX package's __init__ imports resolves through the
    port's package of the same name, and is the port module's own."""
    port = importlib.import_module(f"multi_frame_super_resolution_tpu_torch.{pkg}")
    names = [n for n in _jax_init_names(pkg) if n not in DO_NOT_PORT]
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    ns = {}
    exec(f"from multi_frame_super_resolution_tpu_torch.{pkg} import {', '.join(names)}", ns)
    assert all(ns[n] is getattr(port, n) for n in names)


def test_top_level_imports_config():
    import multi_frame_super_resolution_tpu_torch as port

    assert port.config.BenchConfig().warmup == 5 and port.config.BenchConfig().iters == 20


@pytest.mark.parametrize("module", list(_jax_modules()))
def test_module_defs_match_jax(module):
    """Each public top-level def and class of each JAX module has a
    counterpart in the port's module of the same path (the port's
    data/datasets.py re-exports its synthetic bursts)."""
    tree = ast.parse((JAX_PKG / (module.replace(".", "/") + ".py")).read_text())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and not n.name.startswith("_") and n.name not in DO_NOT_PORT]
    port = importlib.import_module(f"multi_frame_super_resolution_tpu_torch.{module}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
