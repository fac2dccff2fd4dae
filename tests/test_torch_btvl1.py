"""BTV-L1 super-resolution of the port against the JAX package on the CPU:
the fused degradation operators and the BTV prior, the solver on
injected flows (RGB and gray, both warp forms, a ragged size, 3 and 10
iterations), btvl1_video with each flow backend, the Laplacian sharpen,
and the device rule of the entry points."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models import btvl1 as jbtv
from multi_frame_super_resolution_tpu.ops import filters as jfilters
from multi_frame_super_resolution_tpu_torch.config import BTVConfig
from multi_frame_super_resolution_tpu_torch.data import synthetic_burst
from multi_frame_super_resolution_tpu_torch.models import btvl1
from multi_frame_super_resolution_tpu_torch.ops import filters

PSNR_MIN = 60.0


def _planes(x: np.ndarray) -> torch.Tensor:
    """(H, W[, C]) numpy -> channel-leading planes (C, H, W) or (H, W)."""
    t = tt(x)
    return t.permute(2, 0, 1) if t.ndim == 3 else t


def _hwc(t: torch.Tensor) -> np.ndarray:
    return nn(t.permute(1, 2, 0) if t.ndim == 3 else t)


@pytest.mark.parametrize("shape", [(26, 46), (27, 46, 3)])
@pytest.mark.parametrize("s", [2, 3])
def test_operators_match_jax(s, shape):
    """_blur_decimate, _adjoint_blur_up and _btv_gradient against the
    JAX helpers, RGB and gray, on a ragged size: within 1e-6."""
    rng = np.random.default_rng(s)
    cfg = BTVConfig(scale=s)
    jcfg = to_jax(cfg)
    x = rng.random(shape).astype(np.float32)
    r = (rng.random((shape[0] // s, shape[1] // s) + shape[2:]) * 2.0 - 1.0).astype(np.float32)
    pairs = [
        (jax.jit(lambda v: jbtv._blur_decimate(v, jcfg, s))(jnp.asarray(x)), btvl1._blur_decimate(_planes(x), cfg, s)),
        (jax.jit(lambda v: jbtv._adjoint_blur_up(v, jcfg, s))(jnp.asarray(r)), btvl1._adjoint_blur_up(_planes(r), cfg, s)),
        (jax.jit(lambda v: jbtv._btv_gradient(v, jcfg))(jnp.asarray(x)), btvl1._btv_gradient(_planes(x), cfg)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(_hwc(got), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("s", [2, 3])
def test_fused_operators_equal_compositions(s):
    """The fused forms against the compositions they stand for (the JAX
    package pins the same): _block_mean(_blur(x)) and
    _blur(_block_mean_adjoint(r)), borders included."""
    rng = np.random.default_rng(10 + s)
    cfg = BTVConfig(scale=s)
    x = tt(rng.random((3, 48, 66)).astype(np.float32))
    np.testing.assert_allclose(
        nn(btvl1._blur_decimate(x, cfg, s)), nn(btvl1._block_mean(btvl1._blur(x, cfg), s)), rtol=0, atol=2e-6
    )
    r = tt(rng.random((3, 17, 23)).astype(np.float32))
    np.testing.assert_allclose(
        nn(btvl1._adjoint_blur_up(r, cfg, s)), nn(btvl1._blur(btvl1._block_mean_adjoint(r, s), cfg)),
        rtol=0, atol=2e-6,
    )


@pytest.mark.parametrize("s", [2, 3])
def test_fused_pair_is_adjoint(s):
    """<A x, y> == <x, A^T y> for A = _blur_decimate and A^T =
    _adjoint_blur_up, in float64, with x zero within 12 px of the border
    (where the replicate border makes the pair a transpose only up to the
    edge rows)."""
    rng = np.random.default_rng(20 + s)
    cfg = BTVConfig(scale=s)
    x = torch.zeros(2, 60, 84, dtype=torch.float64)
    x[:, 12:-12, 12:-12] = torch.from_numpy(rng.standard_normal((2, 36, 60)))
    y = torch.from_numpy(rng.standard_normal((2, 60 // s, 84 // s)))
    lhs = float((btvl1._blur_decimate(x, cfg, s) * y).sum())
    rhs = float((x * btvl1._adjoint_blur_up(y, cfg, s)).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_btv_gradient_zero_on_constant():
    g = btvl1._btv_gradient(torch.full((1, 16, 16), 0.5), BTVConfig())
    assert float(g.abs().max()) == 0.0


@pytest.fixture(scope="module")
def window():
    """A 3-frame window at 26 x 46 (ragged for the T=16 tiles at scale 2,
    52 x 92) and injected flows of up to ~4 px, RGB and gray."""
    gray, _ = synthetic_burst(np.random.default_rng(0), 3, 26, 46, 2.0)
    rgb = np.stack([gray, gray**1.1, gray**0.9], axis=-1).astype(np.float32)
    flows = (np.random.default_rng(3).standard_normal((3, 26, 46, 2)) * 1.5).astype(np.float32)
    return {"rgb": rgb, "gray": gray}, flows


@functools.lru_cache(maxsize=None)
def _jax_superres(iterations, fast):
    """The jitted JAX btvl1_superres (target 1, injected flows), one per
    configuration in the module."""
    cfg = to_jax(BTVConfig(iterations=iterations, fast=fast))
    return jax.jit(lambda b, f: jbtv.btvl1_superres(b, 1, cfg, flows=f))


@pytest.mark.parametrize("color", ["rgb", "gray"])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("iterations", [3, 10])
def test_superres_with_injected_flows_matches_jax(window, iterations, fast, color):
    """The solver alone, flows injected (every window frame warped, the
    center too): PSNR >= 60 dB against the jitted JAX function (measured
    92-148 dB; the sign-valued gradients flip where a residual lies
    within rounding of 0)."""
    bursts, flows = window
    burst = bursts[color]
    want = np.asarray(_jax_superres(iterations, fast)(jnp.asarray(burst), jnp.asarray(flows)))
    got = nn(btvl1.btvl1_superres(tt(burst), 1, BTVConfig(iterations=iterations, fast=fast), flows=tt(flows),
                                  device="cpu"))
    assert got.shape == want.shape == (52, 92) + burst.shape[3:]
    assert psnr(got, want) >= PSNR_MIN


@pytest.fixture(scope="module")
def video_burst():
    gray, _ = synthetic_burst(np.random.default_rng(1), 3, 32, 48, 2.0)
    return np.stack([gray, gray**1.1, gray**0.9], axis=-1).astype(np.float32)


@pytest.mark.parametrize("method", ["pyrlk", "farneback", "tvl1", "brox"])
def test_video_matches_jax(video_burst, method):
    """btvl1_video with each backend estimating its flows, 3 x 32 x 48 x 3
    at the default BTVConfig (10 iterations): PSNR >= 60 dB against the
    jitted JAX function (measured 75 dB pyrlk, whose bf16 LK sums differ
    by up to 0.02 px: test_torch_flow.py; 81-87 dB the others)."""
    cfg = BTVConfig(optical_flow=method)
    want = np.asarray(jax.jit(lambda b: jbtv.btvl1_video(b, to_jax(cfg)))(jnp.asarray(video_burst)))
    got = nn(btvl1.btvl1_video(tt(video_burst), cfg, device="cpu"))
    assert got.shape == want.shape == (3, 64, 96, 3)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert psnr(got, want) >= PSNR_MIN


def test_video_window_equals_superres(video_burst):
    """A frame of btvl1_video (every window in one batch) equals
    btvl1_superres of that frame (one window)."""
    cfg = BTVConfig(iterations=3, optical_flow="farneback")
    video = nn(btvl1.btvl1_video(tt(video_burst[..., 0]), cfg, device="cpu"))
    one = nn(btvl1.btvl1_superres(tt(video_burst[..., 0]), 2, cfg, device="cpu"))
    np.testing.assert_allclose(video[2], one, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(26, 46), (40, 56, 3)])
def test_laplacian_sharpen_is_exact(shape):
    img = np.random.default_rng(7).random(shape).astype(np.float32) * 0.5 + 0.25
    want = np.asarray(jax.jit(jfilters.laplacian_sharpen)(jnp.asarray(img)))
    np.testing.assert_array_equal(nn(filters.laplacian_sharpen(tt(img))), want)


def test_gaussian_blur_matches_jax():
    img = np.random.default_rng(8).random((30, 41)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jfilters.gaussian_blur(v, 0.8, 5))(jnp.asarray(img)))
    np.testing.assert_allclose(nn(filters.gaussian_blur(tt(img), 0.8, 5)), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(filters.gaussian_kernel_1d(1.3), jfilters.gaussian_kernel_1d(1.3))


def test_entry_points_raise_without_card_unless_cpu_is_asked(monkeypatch):
    """No card and no device request: both entry points raise rather than
    run on the CPU; with device="cpu" they run there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    burst = tt(np.random.default_rng(9).random((3, 16, 16)).astype(np.float32))
    cfg = BTVConfig(iterations=1, optical_flow="farneback")
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        btvl1.btvl1_video(burst, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        btvl1.btvl1_superres(burst, 0, cfg)
    assert btvl1.btvl1_video(burst, cfg, device="cpu").shape == (3, 32, 32)
    assert btvl1.btvl1_superres(burst, 0, cfg, device=torch.device("cpu")).device.type == "cpu"
