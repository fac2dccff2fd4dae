"""The RAW plane-domain order-1 merge (certless plugin branch): its plain
PyTorch version against the JAX merge_burst_raw_planes, and the kernel
wrapper's contract on the CPU. The Hopper kernel is held against the
plain version on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import merge_raw, tap_table
from multi_frame_super_resolution_tpu_torch.models import fast_merge


def _inputs(rng, f, hh, hw, rb_wider=False):
    """Random merge inputs as tests/test_pallas_ops.py makes them, on CFA
    planes; residual in RAW units up to +-2 so the clip is exercised."""
    planes = rng.random((f, 2, 2, hh, hw)).astype(np.float32)
    residual = ((rng.random((f, hh, hw, 2)) - 0.5) * 4.0).astype(np.float32)
    certainty = rng.random((f, hh, hw, 3)).astype(np.float32)
    omega = (0.5 + rng.random((hh, hw, 3))).astype(np.float32)
    omega[..., 2] *= 0.1  # keep the quadratic PSD-ish
    omega_rb = (omega * 0.5) if rb_wider else omega.copy()
    return planes, residual, certainty, omega, omega_rb.astype(np.float32)


def test_active_taps_with_prune_exp():
    for prune in (6.0, 3.0, 1.5, 1.0):
        for r, rb, s, k in ((2, 1.0, 2, 1.0), (3, 1.0, 2, 4.0), (1, 0.5, 3, 0.25)):
            assert fast_merge._active_taps(r, rb, s, k, prune) == jfm._active_taps(r, rb, s, k, prune)
    # the RAW path's taps: radius 1 + residual bound 1 at e^-1.5
    assert len(fast_merge._active_taps(2, 1.0, 2, 1.0, 1.5)) == 21


@pytest.mark.parametrize(
    "cfa,radius,prune,rb_wider",
    [
        (((0, 1), (1, 2)), 1, 1.5, False),
        (((0, 1), (1, 2)), 1, 1.5, True),
        (((2, 1), (1, 0)), 2, 6.0, True),
        (((1, 0), (2, 1)), 1, 3.0, False),
    ],
)
def test_plain_raw_merge_matches_jax(cfa, radius, prune, rb_wider):
    """F = 3 at 16 x 24 half-res, certless order-1 (m00, cy, cx, b0): sums
    of up to F * |taps| f32 terms; rtol and atol 1e-5."""
    ins = _inputs(np.random.default_rng(radius), 3, 16, 24, rb_wider)
    want = jfm.merge_burst_raw_planes(
        *map(jnp.asarray, ins), cfa, 2, radius, residual_bound=1.0, k_max=1.0,
        phase_output=True, order=1, prune_exp=prune, moment_slots=4, centroid_cert=False,
    )
    LAUNCHES.clear()
    got = merge_raw(*map(tt, ins), cfa, 2, radius, 1.0, 1.0, prune)
    assert not LAUNCHES  # CPU tensors take the plain version
    assert len(got) == len(want) == 4
    for name, g, w_ in zip(("m00", "cy", "cx", "b0"), got, want):
        assert g.shape == (4, 4, 3, 16, 24), name
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-5, atol=1e-5, err_msg=name)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    ins = [tt(x) for x in _inputs(rng, 2, 8, 10)]
    cfa = ((0, 1), (1, 2))
    got = merge_raw(*ins, cfa, 2, 1, 1.0, 1.0, 1.5)
    want = fast_merge.merge_burst_raw_planes(*ins, cfa, 2, 1, 1.0, 1.0, 1.5)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


def test_tap_table():
    """Each parity reads the plane and offset of the JAX loop, and each tap
    feeds exactly the chains its tap parity keys (green: (ky+kx)%2 with the
    green weights; R/B: (ky%2, kx%2))."""
    cfa = ((0, 1), (1, 2))
    taps = fast_merge._active_taps(2, 1.0, 2, 1.0, 1.5)
    table = tap_table(tuple(taps), cfa).reshape(len(taps), 22)
    for (ky, kx), row in zip(taps, table):
        assert (row[0], row[1]) == (ky, kx)
        for z in range(4):
            a, b = divmod(z, 2)
            plane, da, db, ch, mask = row[2 + 5 * z : 7 + 5 * z]
            qa, qb = (a + ky) % 2, (b + kx) % 2
            assert (plane, da, db, ch) == (2 * qa + qb, (a + ky) // 2, (b + kx) // 2, cfa[qa][qb])
            # on a Bayer pattern a tap feeds the chain of the channel it reads
            assert mask == 1 << ch


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "omega_rb"])
def test_wrapper_rejects_bad_inputs(rng, bad):
    planes, residual, cert, omega, omega_rb = [tt(x) for x in _inputs(rng, 2, 8, 10)]
    if bad == "dtype":
        planes = planes.double()
    elif bad == "shape":
        residual = residual[..., :1]
    elif bad == "contiguity":
        cert = cert.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        omega_rb = omega_rb[:4]
    with pytest.raises((TypeError, ValueError)):
        merge_raw(planes, residual, cert, omega, omega_rb, ((0, 1), (1, 2)), 2, 1, 1.0, 1.0, 1.5)
