"""The merge: its plain PyTorch version against the Pallas kernel
(interpret mode) and the XLA static-tap merge, the kernel wrapper's
contract, and the merge helpers. The Hopper kernel itself is held
against the plain version on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu.models import merge as jmerge
from multi_frame_super_resolution_tpu.pallas_ops.merge import merge_fast_pallas
from multi_frame_super_resolution_tpu_torch.config import MergeConfig
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels import merge as merge_kernel
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast, merge_fast_plain
from multi_frame_super_resolution_tpu_torch.models import fast_merge, merge


def _inputs(rng, f, h, w, res_amp=2.0):
    """Random merge inputs as tests/test_pallas_ops.py makes them."""
    warped = rng.random((f, h, w, 3)).astype(np.float32)
    residual = ((rng.random((f, h, w, 2)) - 0.5) * res_amp).astype(np.float32)
    certainty = rng.random((f, h, w, 3)).astype(np.float32)
    omega = (0.5 + rng.random((h, w, 3))).astype(np.float32)
    omega[..., 2] *= 0.1  # keep the quadratic PSD-ish
    return warped, residual, certainty, omega


def test_active_taps_and_phases():
    for s in (1, 2, 3, 4):
        np.testing.assert_array_equal(
            fast_merge._output_phase_offsets(s), jfm._output_phase_offsets(s)
        )
        for r, rb, k in ((2, 1.0, 1.0), (3, 0.5, 4.0), (1, 1.0, 0.25)):
            assert fast_merge._active_taps(r, rb, s, k) == jfm._active_taps(r, rb, s, k)
    assert len(fast_merge._active_taps(2, 1.0, 2, 1.0)) == 25  # the slice's taps


@pytest.mark.parametrize(
    "r_taps,rb,scale,k_max",
    [(2, 1.0, 2, 1.0), (2, 1.0, 1, 1.0), (3, 1.0, 3, 1.0), (3, 0.5, 4, 4.0), (8, 1.0, 2, 16.0)],
)
def test_wrapper_tap_array_is_cached_active_taps(r_taps, rb, scale, k_max):
    """The wrapper's host tap list: the port's and the JAX package's
    _active_taps as contiguous read-only int32 rows, built once per key
    (the same array on every call, so a launch does no numpy work)."""
    taps = merge_kernel.tap_array(r_taps, rb, scale, k_max)
    assert taps.dtype == np.int32 and taps.flags.c_contiguous and not taps.flags.writeable
    assert [tuple(t) for t in taps.tolist()] == fast_merge._active_taps(r_taps, rb, scale, k_max)
    assert [tuple(t) for t in taps.tolist()] == jfm._active_taps(r_taps, rb, scale, k_max)
    assert merge_kernel.tap_array(r_taps, rb, scale, k_max) is taps
    assert merge_kernel._tap_args(r_taps, rb, scale, k_max) == (taps.ctypes.data, len(taps))


@pytest.mark.parametrize(
    "f,h,w,scale,res_amp",
    [(3, 32, 48, 2, 2.0), (2, 24, 40, 1, 1.0), (2, 20, 40, 2, 1.0)],
)
def test_plain_merge_matches_pallas_merge(rng, f, h, w, scale, res_amp):
    """Scale 2, scale 1, and H = 20 (which the Pallas wrapper sends to the
    XLA merge). Sums of up to F * 25 f32 terms in another order: rtol and
    atol 1e-5, the tolerance of tests/test_pallas_ops.py."""
    ins = _inputs(rng, f, h, w, res_amp)
    num_p, den_p = merge_fast_pallas(
        *map(jnp.asarray, ins), scale=scale, radius=1, residual_bound=1.0,
        block_rows=16, interpret=True,
    )
    num, den = merge_fast_plain(*map(tt, ins), scale, 1, 1.0, 1.0)
    np.testing.assert_allclose(nn(num), nn(num_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn(den), nn(den_p), rtol=1e-5, atol=1e-5)


def test_plain_merge_matches_xla_merge_radius2(rng):
    ins = _inputs(rng, 2, 16, 24)
    want = jfm.merge_burst_fast(*map(jnp.asarray, ins), scale=3, radius=2)
    got = merge_fast_plain(*map(tt, ins), 3, 2)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    ins = [tt(x) for x in _inputs(rng, 2, 12, 16)]
    LAUNCHES.clear()
    got = merge_fast(*ins, 2, 1, 1.0, 1.0)
    want = merge_fast_plain(*ins, 2, 1, 1.0, 1.0)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    assert LAUNCHES["merge_fast"] == 0  # no kernel ran


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "scale"])
def test_wrapper_rejects_bad_inputs(rng, bad):
    warped, residual, cert, omega = [tt(x) for x in _inputs(rng, 2, 12, 16)]
    scale = 2
    if bad == "dtype":
        warped = warped.double()
    elif bad == "shape":
        residual = residual[..., :1]
    elif bad == "contiguity":
        cert = cert.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        scale = 0  # every scale >= 1 runs (scales past 4 on the general kernel)
    with pytest.raises((TypeError, ValueError)):
        merge_fast(warped, residual, cert, omega, scale, 1, 1.0, 1.0)


def test_kernel_params_and_weighting(rng):
    st = (rng.random((10, 12, 3)) * 1e-3).astype(np.float32)
    st[..., 2] -= 5e-4
    st[0, 0] = 0.0  # degenerate tensor
    cfg = MergeConfig()
    np.testing.assert_allclose(
        nn(merge.kernel_params(tt(st), cfg)), nn(jmerge.kernel_params(jnp.asarray(st), to_jax(cfg))),
        rtol=1e-5, atol=1e-5,
    )
    num = rng.random((6, 8, 3)).astype(np.float32)
    den = (rng.random((6, 8, 3)) * 0.03).astype(np.float32)
    den[0, 0] = 0.0
    fb = rng.random((6, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        nn(merge.apply_weighting(tt(num), tt(den), tt(fb), 0.01)),
        nn(jmerge.apply_weighting(jnp.asarray(num), jnp.asarray(den), jnp.asarray(fb), 0.01)),
        rtol=1e-6,
    )
    gray = rng.random((14, 18)).astype(np.float32)
    np.testing.assert_allclose(
        nn(merge.smoothed_structure_tensor(tt(gray), 3)),
        nn(jmerge.smoothed_structure_tensor(jnp.asarray(gray), 3)),
        atol=1e-6,
    )


@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_plain_merge_phase_layout_matches_jax(rng, scale):
    """The default RGB branch's order-0 merge: the phase layout
    (s, s, 3, H, W), taps pruned at e^-1.5 with k_max scaled by (s/2)^2
    as the path does; rtol and atol 1e-5."""
    ins = _inputs(rng, 3, 12, 20)
    k_max = (scale / 2.0) ** 2
    want = jfm.merge_burst_fast(
        *map(jnp.asarray, ins), scale=scale, radius=1, k_max=k_max, phase_output=True, prune_exp=1.5
    )
    got = merge_fast_plain(*map(tt, ins), scale, 1, 1.0, k_max, phase_output=True, prune_exp=1.5)
    assert len(got) == 2
    for g, w_ in zip(got, want):
        assert g.shape == (scale, scale, 3, 12, 20)
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [2, 4])
def test_plain_merge_order1_matches_jax(rng, scale):
    """The plugin solve's order-1 moments (m00, m01, m02, b0), phase layout.
    rtol and atol 1e-4: m01 and m02 sum cw dy and cw dx, whose terms reach
    +-(r + rb) s in either sign (measured 7e-7 here)."""
    ins = _inputs(rng, 3, 12, 20)
    k_max = (scale / 2.0) ** 2
    kw = dict(phase_output=True, order=1, prune_exp=1.5)
    want = jfm.merge_burst_fast(*map(jnp.asarray, ins), scale=scale, radius=1, k_max=k_max, moment_slots=4, **kw)
    got = merge_fast_plain(*map(tt, ins), scale, 1, 1.0, k_max, **kw)
    assert len(got) == len(want) == 4
    for name, g, w_ in zip(("m00", "m01", "m02", "b0"), got, want):
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("merge", [fast_merge.merge_burst_fast, merge_fast], ids=["plain", "wrapper"])
def test_order1_merge_needs_the_phase_layout(rng, merge):
    """The order-1 moments come in the phase layout only (the one form the
    default branch's solve reads): without phase_output the plain version
    and the wrapper on CPU tensors raise."""
    ins = [tt(x) for x in _inputs(rng, 2, 8, 8)]
    with pytest.raises(ValueError, match="phase_output"):
        merge(*ins, 2, 1, 1.0, 1.0, order=1, prune_exp=1.5)


@pytest.mark.parametrize("prune", [6.0, 3.0, 1.5])
def test_wrapper_tap_array_keyed_by_prune_exp(prune):
    """The cached tap list is keyed by prune_exp too: at radius 1 + rb 1,
    s 2, k_max 1 the thresholds keep 25, 25 and 21 taps."""
    taps = merge_kernel.tap_array(2, 1.0, 2, 1.0, prune)
    assert [tuple(t) for t in taps.tolist()] == jfm._active_taps(2, 1.0, 2, 1.0, prune)
    assert len(taps) == {6.0: 25, 3.0: 25, 1.5: 21}[prune]
    assert merge_kernel.tap_array(2, 1.0, 2, 1.0, prune) is taps
    assert merge_kernel._tap_args(2, 1.0, 2, 1.0, prune) == (taps.ctypes.data, len(taps))


@pytest.mark.parametrize(
    "kw",
    [dict(phase_output=True, prune_exp=1.5), dict(phase_output=True, order=1, prune_exp=1.5),
     dict(phase_output=True, prune_exp=1.5, bf16=True)],
    ids=["phase", "order1", "bf16"],
)
def test_wrapper_on_cpu_is_the_plain_version_for_each_form(rng, kw):
    ins = [tt(x) for x in _inputs(rng, 2, 12, 16)]
    LAUNCHES.clear()
    got = merge_fast(*ins, 3, 1, 1.0, 2.25, **kw)
    want = merge_fast_plain(*ins, 3, 1, 1.0, 2.25, **kw)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    assert LAUNCHES["merge_fast"] == 0


def test_wrapper_refuses_interleaved_bf16(rng):
    """The bfloat16 form writes the phase layout: the wrapper refuses it
    interleaved on a CPU tensor as on a CUDA one; order 1, which ignores
    bf16, runs as without it."""
    ins = [tt(x) for x in _inputs(rng, 2, 12, 16)]
    with pytest.raises(ValueError, match="phase layout"):
        merge_fast(*ins, 2, 1, 1.0, 1.0, prune_exp=1.5, bf16=True)
    got = merge_fast(*ins, 2, 1, 1.0, 1.0, phase_output=True, order=1, prune_exp=1.5, bf16=True)
    want = merge_fast_plain(*ins, 2, 1, 1.0, 1.0, phase_output=True, order=1, prune_exp=1.5)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
