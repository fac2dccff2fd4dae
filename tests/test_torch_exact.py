"""The exact 3x3 solve on both fast paths and the RAW order-0 merge: the
plain versions of the three new kernel forms (merge_burst_fast with 9
moment slots, merge_burst_raw_planes at order 0 and with 9 slots) against
the JAX functions at scales 1-4, and RGB_EXACT, RAW_EXACT and RAW_ORDER0
end to end against the jitted JAX pipelines."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import bf16_limit, nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu.models import handheld as jhandheld
from multi_frame_super_resolution_tpu_torch.config import (
    RAW_BENCH,
    RAW_EXACT,
    RAW_ORDER0,
    RGB_EXACT,
    HandheldConfig,
    MergeConfig,
    check_supported,
    check_supported_raw,
)
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_raw_burst, synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast_plain
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import merge_raw_plain
from multi_frame_super_resolution_tpu_torch.models.handheld import (
    handheld_superres,
    handheld_superres_raw,
)

# the moments sum terms of mixed sign up to (r + rb)^2 s^2: their rounding
# does not cancel (chip_smoke.py's ORDER1_TOL)
ORDER1_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def test_exact_and_order0_configs():
    """The named configurations are bench.py's RAW configuration and the
    RGB default with one knob changed; both checks take them."""
    assert RAW_EXACT == dataclasses.replace(RAW_BENCH, merge=MergeConfig(solver="exact"))
    assert RAW_ORDER0 == dataclasses.replace(RAW_BENCH, merge=MergeConfig(order=0))
    assert RGB_EXACT == HandheldConfig(merge=MergeConfig(rgb_order=1, solver="exact"))
    check_supported(RGB_EXACT)
    for cfg in (RAW_EXACT, RAW_ORDER0, dataclasses.replace(RAW_BENCH, fast=False)):
        check_supported_raw(cfg)
        check_supported_raw(dataclasses.replace(cfg, scale=4))


@pytest.mark.parametrize("knob,cfg", [
    ("solver", dataclasses.replace(RAW_BENCH, merge=MergeConfig(solver="newton"))),
])
def test_forms_left_out_still_raise(knob, cfg):
    """A solver the JAX package does not define raises, naming the knob,
    on both paths."""
    with pytest.raises(ValueError, match=knob):
        check_supported_raw(cfg)
    if knob == "solver":
        with pytest.raises(ValueError, match=knob):
            check_supported(dataclasses.replace(RGB_EXACT, merge=MergeConfig(rgb_order=1, solver="newton")))


@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_nine_slot_rgb_merge_matches_jax(scale):
    """merge_burst_fast(order=1, moment_slots=9) in the phase layout at
    e^-1.5 (the default branch's taps, k_max scaled by (s/2)^2) against
    the JAX function: its nine stacks in solve_order1's order."""
    rng = np.random.default_rng(scale)
    f, h, w = 3, 12, 20
    ins = (
        rng.random((f, h, w, 3)).astype(np.float32),
        ((rng.random((f, h, w, 2)) - 0.5) * 2.0).astype(np.float32),
        rng.random((f, h, w, 3)).astype(np.float32),
        np.concatenate([0.5 + rng.random((h, w, 2)), 0.05 + 0.1 * rng.random((h, w, 1))], -1).astype(np.float32),
    )
    k_max = (scale / 2.0) ** 2
    kw = dict(phase_output=True, order=1, prune_exp=1.5, moment_slots=9)
    want = jfm.merge_burst_fast(*map(jnp.asarray, ins), scale, 1, 1.0, k_max, **kw)
    got = merge_fast_plain(*map(tt, ins), scale, 1, 1.0, k_max, **kw)
    assert len(got) == len(want) == 9
    for g, w_ in zip(got, want):
        assert g.shape == (scale, scale, 3, h, w)
        np.testing.assert_allclose(nn(g), nn(w_), **ORDER1_TOL)


def _raw_inputs(rng, f, hh, hw):
    omega = (0.5 + rng.random((hh, hw, 3))).astype(np.float32)
    omega[..., 2] *= 0.1
    return (
        rng.random((f, 2, 2, hh, hw)).astype(np.float32),
        ((rng.random((f, hh, hw, 2)) - 0.5) * 2.5).astype(np.float32),
        rng.random((f, hh, hw, 3)).astype(np.float32),
        omega,
        omega * 0.5,
    )


@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("order,slots", [(0, 2), (1, 9)], ids=["order0", "slots9"])
def test_raw_plane_merge_forms_match_jax(scale, order, slots):
    """merge_burst_raw_planes at order 0 (num, den) and with the exact
    solve's nine moments (parity-interpolated residuals in the
    displacements, block-centre residual in the weights, moments per
    cell and certainty-weighted) against the JAX function, residuals
    beyond the clip, a GRBG pattern. Order 0 within 1e-5, the moments at
    ORDER1_TOL."""
    rng = np.random.default_rng(10 * scale + order)
    ins = _raw_inputs(rng, 3, 10, 14)
    cfa = ((1, 0), (2, 1))
    k_max = (scale / 2.0) ** 2
    kw = dict(order=order, prune_exp=1.5)
    want = jfm.merge_burst_raw_planes(
        *map(jnp.asarray, ins), cfa, scale, 1, 1.0, k_max, phase_output=True, moment_slots=9, **kw)
    got = merge_raw_plain(*map(tt, ins), cfa, scale, 1, 1.0, k_max, moment_slots=9, **kw)
    assert len(got) == len(want) == slots
    for g, w_ in zip(got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, 10, 14)
        np.testing.assert_allclose(nn(g), nn(w_), **(ORDER1_TOL if order else TOL))


@pytest.mark.parametrize(
    "kw", [dict(moment_slots=9), dict(moment_slots=4, centroid_cert=True)], ids=["slots9", "cert4"])
def test_raw_plane_merge_long_burst_matches_jax(kw):
    """The 9-moment and per-cell forms on a 45-frame burst (16 x 32
    half-res, scale 2): more frames than the card kernel took while it
    staged every frame at once (42 at scale 2), which it now streams.
    The plain version against the JAX function at ORDER1_TOL."""
    rng = np.random.default_rng(45)
    ins = _raw_inputs(rng, 45, 16, 32)
    cfa = ((0, 1), (1, 2))
    args = (cfa, 2, 1, 1.0, 1.0)
    want = jfm.merge_burst_raw_planes(*map(jnp.asarray, ins), *args, phase_output=True, order=1,
                                      prune_exp=1.5, **kw)
    got = merge_raw_plain(*map(tt, ins), *args, order=1, prune_exp=1.5, **kw)
    assert len(got) == len(want) == kw["moment_slots"]
    for g, w_ in zip(got, want):
        assert g.shape == (4, 4, 3, 16, 32)
        np.testing.assert_allclose(nn(g), nn(w_), **ORDER1_TOL)


def _jax_raw(raw, cfg):
    return nn(jax.jit(jhandheld.handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(cfg)))


@pytest.mark.parametrize(
    "cfg",
    [
        dataclasses.replace(RAW_EXACT, prealign=False),
        dataclasses.replace(RAW_ORDER0, prealign=False),
        dataclasses.replace(RAW_EXACT, prealign=False, scale=3),
    ],
    ids=["exact", "order0", "exact-scale3"],
)
def test_raw_fast_forms_match_jax_pipeline(cfg):
    """The RAW fast path with the exact solve (9-slot plane merge,
    solve_order1) and with the order-0 merge (apply_weighting), without
    pre-alignment, 4 x 64 x 128 RAW; the exact solve at scale 3 too.
    Measured 110.9 and 109.0 dB at scale 2; 60 dB as for the slice."""
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    want = _jax_raw(raw, cfg)
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    assert not LAUNCHES
    assert got.shape == (64 * cfg.scale, 128 * cfg.scale, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert psnr(got, want) >= 60.0


@pytest.mark.parametrize("cfg", [RAW_EXACT, RAW_ORDER0], ids=["exact", "order0"])
def test_raw_fast_forms_prealigned_match_jax_pipeline(cfg):
    """RAW_EXACT and RAW_ORDER0 themselves (pre-alignment on) on a RAW
    burst rotated as the city burst is."""
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    raw, _ = synthetic_raw_burst(np.random.default_rng(1), 4, 128, 256, 2.5, angles=angles)
    want = _jax_raw(raw, cfg)
    got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    assert psnr(got, want) >= 60.0


@pytest.mark.parametrize("cfg", [
    dataclasses.replace(RAW_EXACT, merge=MergeConfig(solver="exact", guided_rb=True, exact_weights=True)),
    dataclasses.replace(RAW_ORDER0, merge=MergeConfig(order=0, guided_rb=True, bf16=True)),
    dataclasses.replace(RAW_ORDER0, merge=MergeConfig(order=0, bf16=True)),
    dataclasses.replace(RAW_EXACT, merge=MergeConfig(solver="exact", exact_weights=True)),
], ids=["guided-exact_weights", "guided-bf16", "bf16", "exact_weights"])
def test_raw_knob_forms_prealigned_match_jax_pipeline(cfg):
    """RAW_EXACT with exact_weights (the 9-moment form's weights at its
    moments' displacement) and RAW_ORDER0 with bf16 (the bfloat16
    order-0 form), guided and not, on the rotated burst of
    test_raw_fast_forms_prealigned_match_jax_pipeline: the configurations
    that tested their refusal. Measured 81.9, 61.3, 61.6 and 81.6 dB.
    The port's inputs to the merge differ from JAX's by pre-alignment
    and LK's bf16 window sums (RAW_ORDER0 itself: 76.7 dB in float32,
    ROADMAP Queue 3), and the bfloat16 rounding turns those differences
    into bfloat16 steps; the merge alone is the jitted JAX function's bit
    for bit (test_torch_knob_merge.py). The bfloat16 ones are held to
    torch_parity.bf16_limit (60 dB here: JAX's one-ulp spread less 6.02
    dB is higher), the others to the slice's 60 dB."""
    check_supported_raw(cfg)
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    raw, _ = synthetic_raw_burst(np.random.default_rng(1), 4, 128, 256, 2.5, angles=angles)
    want = _jax_raw(raw, cfg)
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    assert not LAUNCHES
    limit = bf16_limit(lambda x: _jax_raw(x, cfg), raw, want) if cfg.merge.bf16 else 60.0
    assert psnr(got, want) >= limit


@pytest.mark.parametrize("cfg", [dataclasses.replace(RGB_EXACT, prealign=False), RGB_EXACT], ids=["nopre", "prealign"])
def test_rgb_exact_matches_jax_pipeline(cfg):
    """The default RGB branch with rgb_order=1 and the exact solve (the
    9-slot phase-layout merge, solve_order1, the gated restore), with and
    without pre-alignment (on a rotated burst). Measured 120.8 dB
    without."""
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:] if cfg.prealign else None
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5, angles=angles)
    want = nn(jax.jit(jhandheld.handheld_superres, static_argnums=1)(jnp.asarray(burst), to_jax(cfg)))
    got = nn(handheld_superres(tt(burst), cfg, device="cpu"))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0
