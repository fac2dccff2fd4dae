"""The dense optical flows of the port against the JAX package on the CPU:
the four backends of create_optical_flow at the default FlowConfig, the
batched call against per-pair calls, the lk_refine warp branches that
pyrlk and the general warp use, decompose_flow and warp_backward."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt, ulp_perturbed

from multi_frame_super_resolution_tpu.ops import geometry as jgeometry
from multi_frame_super_resolution_tpu.ops import warp_fast as jwarp
from multi_frame_super_resolution_tpu.registration import lucas_kanade as jlk
from multi_frame_super_resolution_tpu.registration import optical_flow as jflow
from multi_frame_super_resolution_tpu_torch.config import FlowConfig, LKConfig
from multi_frame_super_resolution_tpu_torch.data import synthetic_burst
from multi_frame_super_resolution_tpu_torch.ops import geometry, warp_fast
from multi_frame_super_resolution_tpu_torch.registration import lucas_kanade, optical_flow

FLOW_TOL_PX = 1e-3


@pytest.fixture(scope="module")
def pair():
    """A reference and two moved frames, 48 x 64, shifted by up to 2.5 px."""
    burst, _ = synthetic_burst(np.random.default_rng(0), 3, 48, 64, 2.5)
    return burst[0], burst[1:]


@functools.lru_cache(maxsize=None)
def _jax_flow_fn(method):
    """The jitted JAX backend at the default FlowConfig, one per module."""
    return jax.jit(jflow.create_optical_flow(to_jax(FlowConfig(method=method))))


def _jax_flows(method, ref, moved, fn=None):
    fn = fn or _jax_flow_fn(method)
    return np.stack([np.asarray(fn(jnp.asarray(ref), jnp.asarray(m))) for m in moved])


def _port_flows(method, ref, moved):
    return nn(optical_flow.create_optical_flow(FlowConfig(method=method))(tt(ref), tt(moved)))


@pytest.mark.parametrize("method", ["farneback", "tvl1", "brox"])
def test_flow_matches_jax(pair, method):
    """The default FlowConfig (3 pyramid levels), both alternates in one
    call of the port against the JAX function per pair: within 1e-3 px
    (measured 2.6e-5 farneback, 7.4e-5 tvl1, 2.9e-5 brox)."""
    ref, moved = pair
    want = _jax_flows(method, ref, moved)
    got = _port_flows(method, ref, moved)
    assert got.shape == want.shape == (2, 48, 64, 2)
    assert np.abs(want).max() > 1.0  # the flows moved
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL_PX)


def test_pyrlk_flow_matches_jax_with_f32_window_sums(pair, monkeypatch):
    """pyrlk with LK's window sums in float32 in both packages
    (LKConfig.bf16 off): within 1e-3 px (measured ~1e-5). Its default
    bf16 sums are held by the next test."""
    ref, moved = pair
    monkeypatch.setattr(jlk, "LKConfig", functools.partial(jlk.LKConfig, bf16=False))
    monkeypatch.setattr(lucas_kanade, "LKConfig", functools.partial(LKConfig, bf16=False))
    fn = jax.jit(jflow.create_optical_flow(to_jax(FlowConfig(method="pyrlk"))))  # traced with the patch
    want = _jax_flows("pyrlk", ref, moved, fn)
    got = _port_flows("pyrlk", ref, moved)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOW_TOL_PX)


def test_pyrlk_flow_within_jax_rounding_spread(pair):
    """pyrlk at the default FlowConfig, whose LK window sums are bf16
    (LKConfig.bf16): a product or partial sum within float32 rounding of a
    bf16 rounding boundary rounds either way, and 15 LK iterations spread
    the step over the image. The JAX function itself moves by as much when
    its inputs move by one float32 ulp (measured 0.023 px max, 6.0e-4 px
    mean; 18% of the values beyond 1e-3 px), so no pixel set isolates it
    (ROADMAP Queue 3). Held here: the port is no further from the JAX
    flows than twice the JAX function's own spread under two such
    perturbations, in max and in mean (measured 0.019 and 6.1e-4 px)."""
    ref, moved = pair
    want = _jax_flows("pyrlk", ref, moved)
    got = _port_flows("pyrlk", ref, moved)
    rng = np.random.default_rng(5)
    spreads = [
        np.abs(_jax_flows("pyrlk", ulp_perturbed(ref, rng), ulp_perturbed(moved, rng)) - want)
        for _ in range(2)
    ]
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 * max(s.max() for s in spreads)
    assert diff.mean() <= 2.0 * max(s.mean() for s in spreads)
    assert diff.mean() < FLOW_TOL_PX


@pytest.mark.parametrize("method", ["pyrlk", "farneback", "tvl1", "brox"])
def test_batched_flows_equal_per_pair_calls(method):
    """Two windows of two alternates each in one call, every reference
    broadcast against its alternates, equal the per-pair calls."""
    burst, _ = synthetic_burst(np.random.default_rng(1), 4, 32, 40, 2.0)
    refs = burst[[0, 1]]
    moved = burst[[[1, 2], [3, 0]]]
    fn = optical_flow.create_optical_flow(FlowConfig(method=method, pyramid_levels=2))
    got = nn(fn(tt(refs)[:, None], tt(moved)))
    want = np.stack([
        np.stack([nn(fn(tt(refs[i]), tt(moved[i, j]))) for j in range(2)]) for i in range(2)
    ])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_available_backends_and_unknown_name():
    assert optical_flow.available_backends() == jflow.available_backends()
    with pytest.raises(ValueError, match="unknown optical flow"):
        optical_flow.create_optical_flow(FlowConfig(method="nope"))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("branch", ["warp_tile", "warp_backward"])
def test_lk_refine_branches_match_jax(branch, bf16):
    """lk_refine's per-tile decomposed warp (warp_tile=16, tile shifts
    re-decomposed each iteration, residual clamped at 2 px) and its
    bilinear gather warp, on flows of up to +-6 px, two iterations. With
    float32 window sums within 1e-4 px (measured ~1e-5); with bf16 ones,
    as test_torch_registration.py::test_lk_refine holds them."""
    burst, _ = synthetic_burst(np.random.default_rng(2), 3, 48, 64, 2.5)
    flow0 = (np.random.default_rng(3).random((2, 48, 64, 2)) * 12.0 - 6.0).astype(np.float32)
    fields = dict(half_window=6, iterations=2, bf16=bf16, warp_tile=16 if branch == "warp_tile" else 0)
    cfg = LKConfig(**fields)
    fn = jax.jit(jax.vmap(lambda g, fl: jlk.lk_refine(jnp.asarray(burst[0]), g, fl, to_jax(cfg))))
    want = nn(fn(jnp.asarray(burst[1:]), jnp.asarray(flow0)))
    got = nn(lucas_kanade.lk_refine(tt(burst[0]), tt(burst[1:]), tt(flow0), cfg))
    assert np.abs(want - flow0).max() > 0.1  # the refinement moved
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
        assert np.mean(np.abs(got - want) < 1e-4) > 0.99
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_decompose_flow_ragged_is_exact():
    """A 52 x 92 flow field (ragged at T=16: edge tiles padded by
    replication before the tile mean), batched: equal integer parts and
    residuals."""
    flow = (np.random.default_rng(4).standard_normal((2, 52, 92, 2)) * 6.0).astype(np.float32)
    tile_int, residual = jax.jit(jax.vmap(lambda f: jwarp.decompose_flow(f, 16)))(jnp.asarray(flow))
    got_int, got_res = warp_fast.decompose_flow(tt(flow), 16)
    assert got_int.dtype == torch.int32 and tuple(got_int.shape) == (2, 4, 6, 2)
    np.testing.assert_array_equal(nn(got_int), np.asarray(tile_int))
    np.testing.assert_array_equal(nn(got_res), np.asarray(residual))


@pytest.mark.parametrize("bound", [16, 6])
def test_tile_bounded_taps_equal_the_two_warps(bound):
    """warp_taps(img, tile_bounded_taps(...)) against
    warp_bounded(tile_warp_select(...)) on a ragged 52 x 92 shape (T=16),
    tile shifts up to +-24 (beyond the +-16 clip), residuals up to +-3
    (beyond the 2 px clamp), three planes sharing one field: exact; both
    within 1e-6 of the JAX composition. bound 16 takes the two-level
    index of the one-hot warp, bound 6 the direct one."""
    rng = np.random.default_rng(7)
    img = rng.random((2, 3, 52, 92)).astype(np.float32)
    ints = rng.integers(-24, 25, (2, 4, 6, 2)).astype(np.int32)
    res = (rng.random((2, 52, 92, 2)) * 6.0 - 3.0).astype(np.float32)
    t_ints, t_res = tt(ints).unsqueeze(1), tt(res).unsqueeze(1)
    two = warp_fast.warp_bounded_planes(warp_fast.tile_warp_select(tt(img), t_ints, 16, bound), t_res, 2)
    got = warp_fast.warp_taps(tt(img), warp_fast.tile_bounded_taps(t_ints, t_res, 16, 2, 52, 92, bound))
    np.testing.assert_array_equal(nn(got), nn(two))
    want = np.stack([
        np.stack([np.asarray(jwarp.warp_bounded(jwarp.tile_warp_select(jnp.asarray(p), jnp.asarray(ints[b]), 16,
                                                                       bound), jnp.asarray(res[b]), 2))
                  for p in img[b]])
        for b in range(2)
    ])
    np.testing.assert_allclose(nn(got), want, rtol=0, atol=1e-6)


def test_warp_backward_matches_jax():
    """Planes with a leading axis against the JAX (H, W, C) form."""
    rng = np.random.default_rng(6)
    img = rng.random((40, 56, 3)).astype(np.float32)
    flow = (rng.standard_normal((40, 56, 2)) * 3.0).astype(np.float32)
    want = np.asarray(jax.jit(jgeometry.warp_backward)(jnp.asarray(img), jnp.asarray(flow)))
    got = nn(geometry.warp_backward_planes(tt(img).permute(2, 0, 1), tt(flow))).transpose(1, 2, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
