"""The RAW merge's guided and per-cell forms: green_guide_planes, and
merge_burst_raw_planes with a guide (order 0, the certless and the
9-moment order 1) and with centroid_cert=True (the per-cell plugin
moments, guided or not), against the JAX functions at scales 1-4; the
merge knobs (exact_weights, the per-cell centroid's block, shared-residual,
pruned and bfloat16 variants, the bfloat16 order 0) guided and not; the
wrapper's form table and the layout flag the pipeline reads from it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu.models.handheld import _certless
from multi_frame_super_resolution_tpu_torch.config import RAW_BENCH, MergeConfig
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast_plain
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import merge_raw, merge_raw_plain, tap_table
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
    got = merge_raw_plain(
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
    guided = merge_raw_plain(*ins, cfa, 2, guide=guide, **kw)
    diff = merge_raw_plain(
        fast_merge.guided_planes(ins[0], guide, cfa), *ins[1:], cfa, 2, **kw)
    unguided = merge_raw_plain(*ins, cfa, 2, **kw)
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
    cell = merge_raw_plain(*ins, cfa, 2, **kw, moment_slots=4, centroid_cert=True)
    nine = merge_raw_plain(*ins, cfa, 2, **kw, moment_slots=9)
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
    want = merge_raw_plain(*ins, cfa, 2, 1, 1.0, 1.0, 1.5, **kw)
    assert len(got) == n_out
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


@pytest.mark.parametrize(
    "merge",
    [MergeConfig(), MergeConfig(centroid_cert=True), MergeConfig(solver="exact"),
     MergeConfig(solver="exact", centroid_cert=True), MergeConfig(guided_rb=True),
     MergeConfig(guided_rb=True, centroid_cert=True), MergeConfig(exact_weights=True),
     MergeConfig(exact_weights=True, centroid_cert=True), MergeConfig(solver="exact", exact_weights=True),
     MergeConfig(exact_weights=True, centroid_block=True, centroid_prune=1.0)],
    ids=["certless", "cert", "exact", "exact-cert", "guided", "guided-cert", "exact_weights",
         "exact_weights-cert", "exact-exact_weights", "exact_weights-block-prune"],
)
def test_precomputed_centroid_follows_the_form(merge):
    """The RAW pipeline reads the certless layout (finished centroid in
    slots 1 and 2) from the form its merge runs; that is the JAX
    package's own predicate, handheld._certless, at every order-1
    configuration the port takes: exact_weights turns the certless form
    off (fast_merge.py:561) and routes the plugin solve to the per-cell
    form."""
    cfg = dataclasses.replace(RAW_BENCH, merge=merge)
    form = fast_merge.raw_merge_form(1, _moment_slots(cfg), merge.centroid_cert, merge.exact_weights)
    assert (form == fast_merge.CERTLESS) == _certless(to_jax(cfg))
    per_cell = merge.centroid_cert or merge.exact_weights
    assert form == {(False, 4): 0, (True, 4): 3}.get((per_cell, _moment_slots(cfg)), 2)


def test_raw_merge_form_rejects_other_slot_counts():
    with pytest.raises(ValueError, match="4 or 9 slots"):
        fast_merge.raw_merge_form(1, 6)
    assert fast_merge.raw_merge_form(0, 9, True) == fast_merge.ORDER0


def test_exact_weights_routes_to_the_per_cell_form():
    """exact_weights alone (centroid_cert off) is the per-cell form under
    the plugin solve, the 9-moment form under the exact solve, and has no
    effect at order 0."""
    assert fast_merge.raw_merge_form(1, 4, False, True) == fast_merge.PER_CELL
    assert fast_merge.raw_merge_form(1, 4, False, False) == fast_merge.CERTLESS
    assert fast_merge.raw_merge_form(1, 9, False, True) == fast_merge.NINE_MOMENTS
    assert fast_merge.raw_merge_form(0, 4, False, True) == fast_merge.ORDER0


# the knobs of the order-1 forms, each against the JAX function called as
# it is (the knobs change no rounding): (keyword arguments, outputs)
KNOBS = {
    "exact_weights": (dict(order=1, moment_slots=4, exact_weights=True), 4),
    "exact_weights9": (dict(order=1, moment_slots=9, exact_weights=True), 9),
    "block": (dict(order=1, moment_slots=4, centroid_cert=True, centroid_block=True), 4),
    "shared_res": (dict(order=1, moment_slots=4, centroid_cert=True, centroid_shared_res=True), 4),
    "prune": (dict(order=1, moment_slots=4, centroid_cert=True, centroid_prune=1.0), 4),
    "prune-shared_res": (dict(order=1, moment_slots=4, centroid_cert=True, centroid_prune=1.0,
                              centroid_shared_res=True), 4),
    "exact_weights-block": (dict(order=1, moment_slots=4, exact_weights=True, centroid_block=True), 4),
}


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("knob", list(KNOBS))
def test_raw_merge_knobs_match_jax(knob, scale, guided):
    """Each knob's branch of merge_burst_raw_planes (fast_merge.py:
    695-831: the exact weights under both solvers, the per-cell
    centroid's block, shared-residual and pruned forms, the prune before
    the block branch and the shared fold's skip of cells no centroid tap
    reached, and the centroid knobs alive under exact_weights without
    centroid_cert) against the JAX function, at the spec of
    test_raw_merge_forms_with_guide_and_cert_match_jax: within 1e-4."""
    kw, n_out = KNOBS[knob]
    rng = np.random.default_rng(100 + 10 * scale + len(knob))
    f, hh, hw = 3, 8, 10
    cfa = ((1, 0), (2, 1))
    ins = _planes_inputs(rng, f, hh, hw)
    guide = np.asarray(jfm.green_guide_planes(jnp.asarray(ins[0]), cfa)) if guided else None
    spec = dict(radius=1, residual_bound=0.5, k_max=(scale / 2.0) ** 2, prune_exp=3.0)
    want = jfm.merge_burst_raw_planes(
        *(jnp.asarray(x) for x in ins), cfa, scale, **spec,
        guide=None if guide is None else jnp.asarray(guide), phase_output=True, **kw,
    )
    got = merge_raw_plain(
        *(tt(x) for x in ins), cfa, scale, **spec, guide=None if guide is None else tt(guide), **kw,
    )
    assert len(got) == len(want) == n_out
    for g, w_ in zip(got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, hh, hw)
        np.testing.assert_allclose(nn(g), np.asarray(w_), **ORDER1_TOL)


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("knob", ["bf16", "centroid_bf16"])
def test_raw_merge_bf16_knobs_match_jitted_jax(knob, scale, guided):
    """The bfloat16 knobs against the JAX function as the pipelines run
    it, jitted: XLA forms a bfloat16 product that feeds a float32 sum in
    float32 (exact for two bfloat16 factors), so the compiled function
    rounds fewer products than the same function run op by op. The order-0
    merge (planes, certainties, weights, w c on the value's path, the
    taps' frame sums and the accumulation in bfloat16) equals it bit for
    bit; the centroid's bfloat16 factors (products and sums in float32)
    within 1e-4, as the other order-1 forms."""
    kw = dict(order=0, bf16=True) if knob == "bf16" else dict(order=1, moment_slots=4, centroid_cert=True,
                                                              centroid_bf16=True)
    rng = np.random.default_rng(200 + scale)
    f, hh, hw = 3, 8, 10
    cfa = ((0, 1), (1, 2))
    ins = _planes_inputs(rng, f, hh, hw)
    guide = np.asarray(jfm.green_guide_planes(jnp.asarray(ins[0]), cfa)) if guided else None
    spec = dict(radius=1, residual_bound=0.5, k_max=(scale / 2.0) ** 2, prune_exp=1.5)

    def jax_merge(*args):
        return jfm.merge_burst_raw_planes(*args[:5], cfa, scale, **spec, guide=args[5], phase_output=True, **kw)

    want = jax.jit(jax_merge)(*(jnp.asarray(x) for x in ins), None if guide is None else jnp.asarray(guide))
    got = merge_raw_plain(
        *(tt(x) for x in ins), cfa, scale, **spec, guide=None if guide is None else tt(guide), **kw,
    )
    tol = dict(rtol=0, atol=0) if knob == "bf16" else ORDER1_TOL
    assert len(got) == len(want) == (2 if knob == "bf16" else 4)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(nn(g), np.asarray(w_, np.float32), **tol)


@pytest.mark.parametrize("phase_output", [True, False], ids=["phases", "interleaved"])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_rgb_merge_bf16_matches_jitted_jax(scale, phase_output):
    """merge_burst_fast(bf16=True), the RGB default branch's bfloat16
    order 0 (values, certainties and weights rounded, w c and v (w c) and
    a frame's tap sums in bfloat16, the frames added in float32), against
    the JAX function jitted as the pipeline runs it, at e^-1.5 with k_max
    scaled by (s/2)^2: bit for bit."""
    rng = np.random.default_rng(300 + scale)
    f, h, w = 3, 12, 20
    ins = (
        rng.random((f, h, w, 3)).astype(np.float32),
        ((rng.random((f, h, w, 2)) - 0.5) * 2.0).astype(np.float32),
        rng.random((f, h, w, 3)).astype(np.float32),
        np.concatenate([0.5 + rng.random((h, w, 2)), 0.05 + 0.1 * rng.random((h, w, 1))], -1).astype(np.float32),
    )
    k_max = (scale / 2.0) ** 2
    kw = dict(phase_output=phase_output, prune_exp=1.5, bf16=True)

    def jax_merge(*args):
        return jfm.merge_burst_fast(*args, scale, 1, 1.0, k_max, **kw)

    want = jax.jit(jax_merge)(*map(jnp.asarray, ins))
    got = merge_fast_plain(*map(tt, ins), scale, 1, 1.0, k_max, **kw)
    assert len(got) == len(want) == 2
    for g, w_ in zip(got, want):
        assert g.shape == ((scale, scale, 3, h, w) if phase_output else (scale * h, scale * w, 3))
        np.testing.assert_allclose(nn(g), np.asarray(w_, np.float32), rtol=0, atol=0)


def test_bf16_order0_rounds():
    """The bfloat16 order-0 merge is another function than the float32
    one: its sums are bfloat16 values, apart from the float32 merge by
    about bfloat16's rounding (2^-8 relative) and by more than float32's."""
    rng = np.random.default_rng(9)
    cfa = ((0, 1), (1, 2))
    ins = [tt(x) for x in _planes_inputs(rng, 3, 8, 10)]
    kw = dict(radius=1, residual_bound=1.0, k_max=1.0, prune_exp=1.5, order=0)
    b16 = merge_raw_plain(*ins, cfa, 2, **kw, bf16=True)
    f32 = merge_raw_plain(*ins, cfa, 2, **kw)
    for b, f in zip(b16, f32):
        torch.testing.assert_close(b, b.to(torch.bfloat16).float(), rtol=0, atol=0)
        rel = ((b - f).abs() / f.abs().clamp_min(1e-3)).max().item()
        assert 1e-4 < rel < 2 ** -5


def test_guided_bf16_is_the_unguided_merge_of_rounded_differences():
    """With bf16 the guide is subtracted from the bfloat16 values and the
    difference rounded, as the JAX function does: the guided merge equals
    the unguided merge of guided_planes(..., bf16=True), bit for bit."""
    rng = np.random.default_rng(5)
    cfa = ((0, 1), (1, 2))
    ins = [tt(x) for x in _planes_inputs(rng, 3, 8, 10)]
    guide = fast_merge.green_guide_planes(ins[0], cfa)
    kw = dict(radius=1, residual_bound=1.0, k_max=1.0, prune_exp=1.5, order=0, bf16=True)
    guided = merge_raw_plain(*ins, cfa, 2, guide=guide, **kw)
    diff = merge_raw_plain(fast_merge.guided_planes(ins[0], guide, cfa, bf16=True), *ins[1:], cfa,
                                             2, **kw)
    for g, d in zip(guided, diff):
        torch.testing.assert_close(g, d, rtol=0, atol=0)


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("knob", ["bf16", "centroid_bf16", "exact_weights", "block", "shared_res", "prune",
                                  "dead-centroid_bf16", "dead-centroid-knobs"])
def test_wrapper_on_cpu_is_the_plain_knob_form(knob, guided):
    """On CPU tensors the wrapper computes the plain version of the knob's
    form bit for bit and nothing launches; a knob its form does not read
    (centroid_bf16 under the block centroid, every centroid knob under the
    certless form) changes nothing, as in the JAX function."""
    rng = np.random.default_rng(11)
    cfa = ((0, 1), (1, 2))
    ins = [tt(x) for x in _planes_inputs(rng, 3, 8, 10)]
    guide = fast_merge.green_guide_planes(ins[0], cfa) if guided else None
    kw = {
        "bf16": dict(order=0, bf16=True),
        "centroid_bf16": dict(centroid_cert=True, centroid_bf16=True),
        "exact_weights": dict(exact_weights=True),
        "block": dict(centroid_cert=True, centroid_block=True),
        "shared_res": dict(centroid_cert=True, centroid_shared_res=True),
        "prune": dict(centroid_cert=True, centroid_prune=1.0),
        "dead-centroid_bf16": dict(centroid_cert=True, centroid_block=True, centroid_bf16=True),
        "dead-centroid-knobs": dict(centroid_block=True, centroid_prune=1.0, centroid_bf16=True, bf16=True),
    }[knob]
    LAUNCHES.clear()
    got = merge_raw(*ins, cfa, 2, 1, 1.0, 1.0, 1.5, guide=guide, **kw)
    assert not LAUNCHES
    want = merge_raw_plain(*ins, cfa, 2, 1, 1.0, 1.0, 1.5, guide=guide, **kw)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)
    if knob.startswith("dead"):
        live = {k: v for k, v in kw.items() if k in ("centroid_cert", "centroid_block")}
        for g, w_ in zip(got, merge_raw_plain(*ins, cfa, 2, 1, 1.0, 1.0, 1.5, guide=guide, **live)):
            torch.testing.assert_close(g, w_, rtol=0, atol=0)


def test_tap_table_marks_the_centroid_taps():
    """The table's centroid bit is set on the taps of the tighter prune
    (centroid_prune 1.0 keeps the inner 3 x 3 of the 21 taps at e^-1.5)
    and on every tap without it."""
    taps = tuple(fast_merge._active_taps(2, 1.0, 2, 1.0, 1.5))
    inner = frozenset(fast_merge._active_taps(2, 1.0, 2, 1.0, 1.0))
    assert len(taps) == 21 and inner == {(y, x) for y in (-1, 0, 1) for x in (-1, 0, 1)}
    cfa = ((0, 1), (1, 2))
    for centroid_taps, want in ((None, set(taps)), (inner, inner)):
        rows = tap_table(taps, cfa, centroid_taps)[8:].reshape(-1, 3)
        assert {(int(y), int(x)) for y, x, aux in rows if aux % 2} == want
