"""The RAW merge's guided and per-cell forms: green_guide_planes, and
merge_burst_raw_planes with a guide (order 0, the certless and the
9-moment order 1) and with centroid_cert=True (the per-cell plugin
moments, guided or not), against the JAX functions at scales 1-4; the
wrapper's form table and the layout flag the pipeline reads from it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu.models.handheld import _certless
from multi_frame_super_resolution_tpu_torch.config import RAW_BENCH, MergeConfig
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import merge_raw
from multi_frame_super_resolution_tpu_torch.models import fast_merge
from multi_frame_super_resolution_tpu_torch.models.handheld import _moment_slots

# order 0 and the certless chains sum w c v, w c and w: rounding alone
TOL = dict(rtol=1e-5, atol=1e-5)
# the order-1 moments sum terms of mixed sign up to (r + rb) s: their
# rounding does not cancel (chip_smoke.py's ORDER1_TOL)
ORDER1_TOL = dict(rtol=1e-4, atol=1e-4)
CFAS = {"rggb": ((0, 1), (1, 2)), "grbg": ((1, 0), (2, 1))}


def _planes_inputs(rng, f, hh, hw):
    planes = rng.random((f, 2, 2, hh, hw)).astype(np.float32)
    residual = rng.normal(0.0, 0.4, (f, hh, hw, 2)).astype(np.float32)
    cert = rng.random((f, hh, hw, 3)).astype(np.float32)
    om_g = (rng.random((hh, hw, 3)) * 0.5 + 0.5).astype(np.float32)
    om_g[..., 2] = 0.1
    om_rb = (rng.random((hh, hw, 3)) * 0.5 + 0.4).astype(np.float32)
    om_rb[..., 2] = 0.05
    return planes, residual, cert, om_g, om_rb


@pytest.mark.parametrize("cfa", list(CFAS.values()), ids=list(CFAS))
def test_green_guide_planes_matches_jax(cfa):
    """The Hamilton-Adams / Wu-Zhang green estimate at R/B sites, the
    green sites themselves, edge-clamped shifts: within 1e-6."""
    planes = np.random.default_rng(0).random((3, 2, 2, 9, 13)).astype(np.float32)
    got = nn(fast_merge.green_guide_planes(tt(planes), cfa))
    want = np.asarray(jfm.green_guide_planes(jnp.asarray(planes), cfa))
    assert got.shape == planes.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    green = np.asarray(cfa) == 1
    np.testing.assert_array_equal(got[:, green], planes[:, green])


# (order, slots, centroid_cert, outputs, tolerance)
FORMS = {
    "order0": (0, 4, False, 2, TOL),
    "certless": (1, 4, False, 4, ORDER1_TOL),
    "slots9": (1, 9, False, 9, ORDER1_TOL),
    "cert4": (1, 4, True, 4, ORDER1_TOL),
}


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("form", list(FORMS))
def test_raw_merge_forms_with_guide_and_cert_match_jax(form, scale, guided):
    """Every form of merge_burst_raw_planes, with and without a guide
    (green_guide_planes of the planes), against the JAX function in the
    phase layout (tests/test_order1.py:93-125's spec: radius 1, residual
    bound 0.5, e^-3): order 0 within 1e-5, the order-1 forms within 1e-4
    (the certless centroid is a ratio of sums). The unguided cases fix the reference the
    guided ones differ from."""
    order, slots, cert, n_out, tol = FORMS[form]
    rng = np.random.default_rng(10 * scale + len(form))
    f, hh, hw = 3, 8, 10
    cfa = ((1, 0), (2, 1))
    ins = _planes_inputs(rng, f, hh, hw)
    guide = np.asarray(jfm.green_guide_planes(jnp.asarray(ins[0]), cfa)) if guided else None
    kw = dict(radius=1, residual_bound=0.5, k_max=(scale / 2.0) ** 2, prune_exp=3.0)
    want = jfm.merge_burst_raw_planes(
        *(jnp.asarray(x) for x in ins), cfa, scale, **kw,
        guide=None if guide is None else jnp.asarray(guide), phase_output=True, order=order,
        moment_slots=slots, centroid_cert=cert,
    )
    got = fast_merge.merge_burst_raw_planes(
        *(tt(x) for x in ins), cfa, scale, **kw, order=order, moment_slots=slots,
        guide=None if guide is None else tt(guide), centroid_cert=cert,
    )
    assert len(got) == len(want) == n_out
    for g, w_ in zip(got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, hh, hw)
        np.testing.assert_allclose(nn(g), np.asarray(w_), **tol)


@pytest.mark.parametrize("form", ["order0", "certless", "slots9", "cert4"])
def test_guided_merge_is_the_unguided_merge_of_difference_planes(form):
    """The guide is subtracted before the shift, as in the JAX function:
    the guided merge equals the unguided merge of guided_planes, bit for
    bit, and green cells do not see the guide."""
    order, slots, cert, _, _ = FORMS[form]
    rng = np.random.default_rng(5)
    cfa = ((0, 1), (1, 2))
    ins = [tt(x) for x in _planes_inputs(rng, 3, 8, 10)]
    guide = fast_merge.green_guide_planes(ins[0], cfa)
    kw = dict(radius=1, residual_bound=1.0, k_max=1.0, prune_exp=1.5, order=order, moment_slots=slots,
              centroid_cert=cert)
    guided = fast_merge.merge_burst_raw_planes(*ins, cfa, 2, guide=guide, **kw)
    diff = fast_merge.merge_burst_raw_planes(
        fast_merge.guided_planes(ins[0], guide, cfa), *ins[1:], cfa, 2, **kw)
    unguided = fast_merge.merge_burst_raw_planes(*ins, cfa, 2, **kw)
    for g, d, u in zip(guided, diff, unguided):
        torch.testing.assert_close(g, d, rtol=0, atol=0)
        torch.testing.assert_close(g[:, :, 1], u[:, :, 1], rtol=0, atol=0)


def test_per_cell_form_is_the_nine_moment_form_subset():
    """The per-cell plugin moments are, algebraically, slots 0, 1, 2 and 6
    of the 9-moment form (m00, m01, m02, b0): within 1e-4 (m01 and m02 are
    summed as s (k sum w c - sum rho w c) there, sum dy w c here)."""
    rng = np.random.default_rng(3)
    cfa = ((0, 1), (1, 2))
    ins = [tt(x) for x in _planes_inputs(rng, 4, 8, 12)]
    kw = dict(radius=1, residual_bound=1.0, k_max=1.0, prune_exp=1.5, order=1)
    cell = fast_merge.merge_burst_raw_planes(*ins, cfa, 2, **kw, moment_slots=4, centroid_cert=True)
    nine = fast_merge.merge_burst_raw_planes(*ins, cfa, 2, **kw, moment_slots=9)
    for g, k in zip(cell, (0, 1, 2, 6)):
        torch.testing.assert_close(g, nine[k], **ORDER1_TOL)


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("form", list(FORMS))
def test_wrapper_on_cpu_is_the_plain_form(form, guided):
    """On CPU tensors the wrapper computes the plain version of the form
    it would launch, the guide's difference planes formed by the wrapper:
    bit for bit, and nothing launches."""
    order, slots, cert, n_out, _ = FORMS[form]
    rng = np.random.default_rng(7)
    cfa = ((0, 1), (1, 2))
    ins = [tt(x) for x in _planes_inputs(rng, 3, 8, 10)]
    guide = fast_merge.green_guide_planes(ins[0], cfa) if guided else None
    kw = dict(order=order, moment_slots=slots, guide=guide, centroid_cert=cert)
    LAUNCHES.clear()
    got = merge_raw(*ins, cfa, 2, 1, 1.0, 1.0, 1.5, **kw)
    assert not LAUNCHES
    want = fast_merge.merge_burst_raw_planes(*ins, cfa, 2, 1, 1.0, 1.0, 1.5, **kw)
    assert len(got) == n_out
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


@pytest.mark.parametrize(
    "merge",
    [MergeConfig(), MergeConfig(centroid_cert=True), MergeConfig(solver="exact"),
     MergeConfig(solver="exact", centroid_cert=True), MergeConfig(guided_rb=True),
     MergeConfig(guided_rb=True, centroid_cert=True)],
    ids=["certless", "cert", "exact", "exact-cert", "guided", "guided-cert"],
)
def test_precomputed_centroid_follows_the_form(merge):
    """The RAW pipeline reads the certless layout (finished centroid in
    slots 1 and 2) from the form its merge runs; that is the JAX
    package's own predicate, handheld._certless, at every order-1
    configuration the port takes."""
    cfg = dataclasses.replace(RAW_BENCH, merge=merge)
    form = fast_merge.raw_merge_form(1, _moment_slots(cfg), merge.centroid_cert)
    assert (form == fast_merge.CERTLESS) == _certless(to_jax(cfg))
    assert form == {(False, 4): 0, (True, 4): 3}.get((merge.centroid_cert, _moment_slots(cfg)), 2)


def test_raw_merge_form_rejects_other_slot_counts():
    with pytest.raises(ValueError, match="4 or 9 slots"):
        fast_merge.raw_merge_form(1, 6)
    assert fast_merge.raw_merge_form(0, 9, True) == fast_merge.ORDER0
