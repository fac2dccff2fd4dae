"""The handheld knobs the RAW fast path now runs, end to end against the
jitted JAX pipeline on a burst rotated as the city burst is: the guided
R/B merge (config.RAW_GUIDED at order 1, and at order 0 and with the
exact solve), the per-cell centroid (config.RAW_CERT), and LK's
tile-decomposed warp (lk.warp_tile=16); their true-HR PSNR against the
JAX package's; the named configurations, and the paths that ignore the
centroid knobs."""

import dataclasses

import imageio.v3 as iio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import ROOT, city_hr_raw_burst, nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres_raw as jax_handheld_superres_raw,
)
from multi_frame_super_resolution_tpu_torch.config import (
    RAW_BENCH,
    RAW_CERT,
    RAW_CERT_BF16,
    RAW_CERT_BLOCK,
    RAW_CERT_PRUNE,
    RAW_CERT_SHARED,
    RAW_CONSISTENT,
    RAW_EXACT,
    RAW_EXACT_WEIGHTS,
    RAW_FFT,
    RAW_GUIDED,
    RAW_ONEHOT_WARP,
    RAW_ORDER0,
    RAW_ORDER0_BF16,
    RGB_BF16,
    RGB_CONSISTENT,
    RGB_DEFAULT,
    RGB_HALF_STATS,
    RGB_ONEHOT_WARP,
    RGB_ORACLE,
    AlignConfig,
    HandheldConfig,
    LKConfig,
    MergeConfig,
    check_supported,
    check_supported_raw,
)
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_raw_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models import handheld
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres_raw

RAW_GUIDED_ORDER0 = dataclasses.replace(RAW_BENCH, merge=MergeConfig(guided_rb=True, order=0))
RAW_GUIDED_EXACT = dataclasses.replace(RAW_BENCH, merge=MergeConfig(guided_rb=True, solver="exact"))
RAW_WARP_TILE = dataclasses.replace(RAW_BENCH, lk=LKConfig(warp_tile=16))


@pytest.fixture(scope="module")
def rotated_raw_burst():
    """F = 5 at 128 x 256 RAW, frames rotated 0/0/5/10/-15 degrees."""
    return synthetic_raw_burst(np.random.default_rng(0), 5, 128, 256, 2.5, angles=CITY_ANGLES)[0]


def test_named_configurations():
    """Each is bench.py's RAW configuration (or the RGB default) with one
    knob set, and both checks take it (and it at scale 4)."""
    assert RAW_GUIDED == dataclasses.replace(RAW_BENCH, merge=MergeConfig(guided_rb=True))
    assert RAW_CERT == dataclasses.replace(RAW_BENCH, merge=MergeConfig(centroid_cert=True))
    assert RAW_CONSISTENT == dataclasses.replace(RAW_BENCH, use_consistency=True)
    assert RAW_FFT == dataclasses.replace(
        RAW_BENCH, align=AlignConfig(tile_size=16, search_radius=4, levels=2, use_fft=True))
    assert RGB_CONSISTENT == HandheldConfig(use_consistency=True)
    for cfg in (RAW_GUIDED, RAW_CERT, RAW_CONSISTENT, RAW_FFT, RAW_WARP_TILE, RAW_GUIDED_ORDER0, RAW_GUIDED_EXACT):
        check_supported_raw(cfg)
        check_supported_raw(dataclasses.replace(cfg, scale=4))
    check_supported(RGB_CONSISTENT)
    check_supported(dataclasses.replace(RGB_DEFAULT, align=AlignConfig(use_fft=True), lk=LKConfig(warp_tile=16)))


def test_merge_and_warp_knob_configurations():
    """The configurations of the merge and warp knobs: each bench.py's
    RAW configuration (RAW_CERT for the per-cell centroid's variants,
    RAW_ORDER0 for the bfloat16 order 0) or the RGB default with one knob
    set, and both checks take them, at scale 4 too."""
    assert RAW_EXACT_WEIGHTS == dataclasses.replace(RAW_BENCH, merge=MergeConfig(exact_weights=True))
    for knob, cfg in (("centroid_block", RAW_CERT_BLOCK), ("centroid_shared_res", RAW_CERT_SHARED),
                      ("centroid_bf16", RAW_CERT_BF16)):
        assert cfg == dataclasses.replace(RAW_CERT, merge=dataclasses.replace(RAW_CERT.merge, **{knob: True}))
    assert RAW_CERT_PRUNE == dataclasses.replace(RAW_CERT, merge=dataclasses.replace(RAW_CERT.merge, centroid_prune=1.0))
    assert RAW_ORDER0_BF16 == dataclasses.replace(RAW_ORDER0, merge=dataclasses.replace(RAW_ORDER0.merge, bf16=True))
    assert RAW_ONEHOT_WARP == dataclasses.replace(RAW_BENCH, warp_matmul=False)
    assert RGB_BF16 == dataclasses.replace(RGB_DEFAULT, merge=MergeConfig(bf16=True))
    assert RGB_HALF_STATS == dataclasses.replace(RGB_DEFAULT, rgb_half_stats=True)
    assert RGB_ONEHOT_WARP == dataclasses.replace(RGB_DEFAULT, warp_matmul=False)
    for cfg in (RAW_EXACT_WEIGHTS, RAW_CERT_BLOCK, RAW_CERT_SHARED, RAW_CERT_PRUNE, RAW_CERT_BF16, RAW_ORDER0_BF16,
                RAW_ONEHOT_WARP):
        check_supported_raw(cfg)
        check_supported_raw(dataclasses.replace(cfg, scale=4))
    for cfg in (RGB_BF16, RGB_HALF_STATS, RGB_ONEHOT_WARP):
        check_supported(cfg)
        check_supported(dataclasses.replace(cfg, scale=4))


@pytest.mark.parametrize("check,cfg", [
    (check_supported, dataclasses.replace(RGB_DEFAULT, merge=MergeConfig(centroid_cert=True, guided_rb=True))),
    (check_supported, dataclasses.replace(RGB_ORACLE, merge=MergeConfig(centroid_cert=True, guided_rb=True))),
    (check_supported_raw, dataclasses.replace(RAW_BENCH, fast=False, merge=MergeConfig(
        centroid_cert=True, guided_rb=True, centroid_prune=1.0, centroid_block=True))),
    (check_supported_raw, dataclasses.replace(RAW_BENCH, merge=MergeConfig(
        centroid_prune=1.0, centroid_bf16=True, centroid_block=True, centroid_shared_res=True))),
    (check_supported_raw, dataclasses.replace(RAW_EXACT, merge=MergeConfig(
        solver="exact", centroid_cert=True, centroid_block=True))),
    (check_supported_raw, dataclasses.replace(RAW_ORDER0, merge=MergeConfig(
        order=0, centroid_cert=True, centroid_prune=1.0))),
], ids=["rgb-fast", "rgb-oracle", "raw-oracle", "raw-certless", "raw-exact", "raw-order0"])
def test_paths_that_ignore_the_centroid_knobs_take_them(check, cfg):
    """The RGB paths and the oracles ignore centroid_cert and guided_rb, and
    the certless default, the exact solve and order 0 ignore the centroid
    knobs, as the JAX functions do: none of them raises."""
    check(cfg)


@pytest.mark.parametrize("cfg", [RAW_GUIDED, RAW_GUIDED_ORDER0, RAW_GUIDED_EXACT, RAW_CERT, RAW_WARP_TILE],
                         ids=["guided", "guided-order0", "guided-exact", "cert", "warp_tile"])
def test_raw_knob_matches_jax_pipeline(rotated_raw_burst, cfg):
    """Pre-alignment on, the port's own estimates (they agree with JAX's
    on this burst, test_torch_raw_handheld.py). Measured 99.7-104.5 dB
    for the merge knobs and 76.8 dB for lk.warp_tile, whose bounded warp
    re-decomposes the flow at every LK iteration, so that LK's bf16
    window sums cross more rounding boundaries. 60 dB as for the
    slice."""
    raw = rotated_raw_burst
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(cfg)))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    assert got.shape == (256, 512, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert not LAUNCHES
    assert psnr(got, want) >= 60.0


def test_raw_cert_needs_its_layout_flag(rotated_raw_burst, monkeypatch):
    """RAW_CERT's slots 1 and 2 are raw m01 and m02: read as the
    certless form's finished centroid, the plugin solve computes another
    image, far below the 60 dB that RAW_CERT meets against JAX. So the
    parity above holds only with the flag the merge's form gives."""
    raw = tt(rotated_raw_burst)
    right = nn(handheld_superres_raw(raw, RAW_CERT, device="cpu"))
    monkeypatch.setattr(handheld, "CERTLESS", handheld.raw_merge_form(1, 4, True))
    wrong = nn(handheld_superres_raw(raw, RAW_CERT, device="cpu"))
    assert psnr(wrong, right) < 40.0


def test_raw_exact_weights_needs_the_per_cell_layout(rotated_raw_burst, monkeypatch):
    """exact_weights alone routes the plugin solve to the per-cell form
    (raw m01 and m02 in slots 1 and 2), as the JAX package's _certless
    predicate does: RAW_EXACT_WEIGHTS matches the JAX pipeline at 60 dB
    (measured 95.7 dB), and read as the certless form's finished centroid
    the same merge gives another image, far below that (38.8 dB)."""
    raw = rotated_raw_burst
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(RAW_EXACT_WEIGHTS)))
    right = nn(handheld_superres_raw(tt(raw), RAW_EXACT_WEIGHTS, device="cpu"))
    assert psnr(right, want) >= 60.0
    monkeypatch.setattr(handheld, "CERTLESS", handheld.raw_merge_form(1, 4, False, True))
    wrong = nn(handheld_superres_raw(tt(raw), RAW_EXACT_WEIGHTS, device="cpu"))
    assert psnr(wrong, right) < 40.0


def test_merge_knobs_true_hr_match_jax():
    """On the true-HR burst of the fidelity tests (5 frames of the city
    scene's top-left 256 x 512, factor 2; 16 px margin) each of RAW_BENCH,
    RAW_GUIDED and RAW_CERT scores within 0.05 dB of the JAX pipeline,
    and the port's gap of each knob to RAW_BENCH equals JAX's within
    0.05 dB. Measured: JAX 35.7221, 33.8869, 35.7995 dB; the port
    35.7220, 33.8869, 35.7994. The guided merge loses 1.84 dB in both (the
    JAX config's own verdict on guided_rb: "decisively OFF"), the per-cell
    centroid gains 0.08."""
    raw = city_hr_raw_burst(5, 2, 256, 512)
    hr = iio.imread(ROOT / "city_handheld_sr.png")[:256, :512, :3].astype(np.float32) / 255.0
    m = 16
    p = {}
    for name, cfg in (("default", RAW_BENCH), ("guided", RAW_GUIDED), ("cert", RAW_CERT)):
        want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(cfg)))
        got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
        p["jax", name], p["port", name] = (psnr(x[m:-m, m:-m], hr[m:-m, m:-m]) for x in (want, got))
        assert abs(p["port", name] - p["jax", name]) <= 0.05, p
    for name in ("guided", "cert"):
        gap_port = p["port", name] - p["port", "default"]
        gap_jax = p["jax", name] - p["jax", "default"]
        assert abs(gap_port - gap_jax) <= 0.05, p


@pytest.mark.parametrize("cfg", [RAW_EXACT_WEIGHTS, RAW_CERT_BLOCK, RAW_CERT_SHARED, RAW_CERT_PRUNE, RAW_CERT_BF16,
                                 RAW_ORDER0_BF16, RAW_ONEHOT_WARP],
                         ids=["exact_weights", "block", "shared_res", "prune", "centroid_bf16", "order0-bf16",
                              "onehot"])
def test_merge_and_warp_knobs_true_hr_match_jax(cfg):
    """The RAW knobs' true-HR PSNR (test_merge_knobs_true_hr_match_jax's
    burst and margin) within 0.05 dB of the JAX pipeline's: what each knob
    costs or gains is the JAX function's own. Measured, JAX / port:
    exact_weights 35.9116 / 35.9116, block 35.7209 / 35.7208, shared_res 31.0643 /
    31.0641 (4.7 dB under RAW_CERT's 35.80 in both: the shared fold
    scales phase 0's mean residual by each phase's weight), prune
    35.5666 / 35.5665, centroid_bf16 35.7999 / 35.7998, order0-bf16 34.1814 / 34.1811,
    onehot 34.9160 / 34.9159."""
    raw = city_hr_raw_burst(5, 2, 256, 512)
    hr = iio.imread(ROOT / "city_handheld_sr.png")[:256, :512, :3].astype(np.float32) / 255.0
    m = 16
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(cfg)))
    got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    p_jax, p_port = (psnr(x[m:-m, m:-m], hr[m:-m, m:-m]) for x in (want, got))
    assert abs(p_port - p_jax) <= 0.05, (p_port, p_jax)
