"""The merge: its plain PyTorch version against the Pallas kernel
(interpret mode) and the XLA static-tap merge, the kernel wrapper's
contract, and the merge helpers. The Hopper kernel itself is held
against the plain version on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.config import MergeConfig
from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu.models import merge as jmerge
from multi_frame_super_resolution_tpu.pallas_ops.merge import merge_fast_pallas
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast
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
    num, den = fast_merge.merge_burst_fast(*map(tt, ins), scale, 1, 1.0, 1.0)
    np.testing.assert_allclose(nn(num), nn(num_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nn(den), nn(den_p), rtol=1e-5, atol=1e-5)


def test_plain_merge_matches_xla_merge_radius2(rng):
    ins = _inputs(rng, 2, 16, 24)
    want = jfm.merge_burst_fast(*map(jnp.asarray, ins), scale=3, radius=2)
    got = fast_merge.merge_burst_fast(*map(tt, ins), 3, 2)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    ins = [tt(x) for x in _inputs(rng, 2, 12, 16)]
    LAUNCHES.clear()
    got = merge_fast(*ins, 2, 1, 1.0, 1.0)
    want = fast_merge.merge_burst_fast(*ins, 2, 1, 1.0, 1.0)
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
        scale = 5
    with pytest.raises((TypeError, ValueError)):
        merge_fast(warped, residual, cert, omega, scale, 1, 1.0, 1.0)


def test_kernel_params_and_weighting(rng):
    st = (rng.random((10, 12, 3)) * 1e-3).astype(np.float32)
    st[..., 2] -= 5e-4
    st[0, 0] = 0.0  # degenerate tensor
    cfg = MergeConfig()
    np.testing.assert_allclose(
        nn(merge.kernel_params(tt(st), cfg)), nn(jmerge.kernel_params(jnp.asarray(st), cfg)),
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
