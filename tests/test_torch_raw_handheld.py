"""The RAW main path end to end: handheld_superres_raw on a mosaicked
burst under config.RAW_PORT_DEFAULT and its windows-branch variant
(align.fast_extract=False), and under config.RAW_BENCH (bench.py's
configuration, global pre-alignment on) on a burst rotated as the city
burst is, against the jitted JAX pipeline; the knob values
check_supported_raw rejects; and the merge and warp knobs it used to
reject (some of them alive only under merge.centroid_cert=True or
merge.exact_weights=True, where they select other functions) against
the JAX pipeline."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bf16_limit, nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres_raw as jax_handheld_superres_raw,
)
from multi_frame_super_resolution_tpu.ops import restore as jrestore
from multi_frame_super_resolution_tpu.registration import logpolar as jlogpolar
from multi_frame_super_resolution_tpu_torch.config import (
    PREALIGN_FAST,
    RAW_BENCH,
    RAW_PORT_DEFAULT,
    AlignConfig,
    HandheldConfig,
    MergeConfig,
    check_supported_raw,
)
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_raw_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models import handheld
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres_raw
from multi_frame_super_resolution_tpu_torch.ops import restore
from multi_frame_super_resolution_tpu_torch.registration.logpolar import similarity_from_numpy

RAW_SLICE = HandheldConfig(
    align=AlignConfig(tile_size=16, search_radius=4, levels=2), gamma=False, prealign=False
)
WINDOWS = dataclasses.replace(
    RAW_SLICE, align=AlignConfig(tile_size=16, search_radius=4, levels=2, fast_extract=False)
)


@pytest.fixture(scope="module")
def raw_burst():
    """F = 4 at 128 x 256 RAW (64 x 128 half-res), motion up to 2.5 px."""
    return synthetic_raw_burst(np.random.default_rng(0), 4, 128, 256, 2.5)[0]


@pytest.fixture(scope="module")
def rotated_raw_burst():
    """F = 5 at 128 x 256 RAW, frames rotated 0/0/5/10/-15 degrees as the
    city burst's are, so the pre-alignment warps three of them."""
    return synthetic_raw_burst(
        np.random.default_rng(0), 5, 128, 256, 2.5, angles=CITY_ANGLES
    )[0]


def test_raw_port_default_is_the_slice():
    assert RAW_PORT_DEFAULT == RAW_SLICE
    check_supported_raw(RAW_SLICE)
    check_supported_raw(WINDOWS)


@pytest.mark.parametrize("cfg", [RAW_SLICE, WINDOWS], ids=["fast_extract", "windows"])
def test_raw_slice_matches_jax_pipeline(raw_burst, cfg):
    """Measured 81 dB (fast branch) and 96 dB (windows branch): every
    stage matches to f32 rounding except the Lucas-Kanade bf16 window sums,
    which can land one bf16 step apart and move a few pixels by ~1e-2 where
    a flow crosses a rounding boundary of the robustness model. 60 dB
    leaves room for that."""
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw_burst), to_jax(cfg)))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw_burst), cfg, device="cpu"))
    assert got.shape == (256, 512, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert not LAUNCHES  # CPU tensors take the plain versions
    assert psnr(got, want) >= 60.0


def test_raw_bench_matches_jax_pipeline(rotated_raw_burst):
    """bench.py's configuration end to end: the port estimates the
    similarities itself (64 x 128 half-res luma, the ds=1 branch). The
    estimates agree with JAX's exactly on this burst (measured 103.5 dB,
    max abs 4.8e-4), so the limit is the slice's 60 dB."""
    assert RAW_BENCH == HandheldConfig(
        align=AlignConfig(tile_size=16, search_radius=4, levels=2), gamma=False
    )
    check_supported_raw(RAW_BENCH)
    raw = rotated_raw_burst
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(RAW_BENCH)))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw), RAW_BENCH, device="cpu"))
    assert got.shape == (256, 512, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert not LAUNCHES
    assert psnr(got, want) >= 60.0


@pytest.mark.parametrize(
    "align",
    [
        AlignConfig(tile_size=16, search_radius=4, levels=2, fine_radius=2),
        AlignConfig(tile_size=16, search_radius=4, levels=2, fine_radius=0),
        AlignConfig(tile_size=12, search_radius=4, levels=2),
    ],
    ids=["fine_radius2", "fine_radius0", "tile12"],
)
def test_raw_bench_align_variants_match_jax_pipeline(rotated_raw_burst, align):
    """RAW_BENCH with the finest level's search radius cut to 2 (the JAX
    config's value for smooth-motion bursts) or to 0 (the coarse level's
    prediction alone: every minimum of a 1 x 1 surface is a border
    minimum, so each fine tile's residual shift is 0, as in JAX), and at
    a tile size of 12, against the jitted JAX pipeline. On the card the
    last two run the general tile search (csrc/tile_search.cu).
    Measured 103.5, 105.1 and 85.5 dB."""
    cfg = dataclasses.replace(RAW_BENCH, align=align)
    check_supported_raw(cfg)
    raw = rotated_raw_burst
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(cfg)))
    got = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    assert got.shape == (256, 512, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0


def test_raw_bench_given_one_transform(rotated_raw_burst):
    """prealign_override: one half-res SimilarityTransform fed to both
    pipelines, about the center of a larger global image whose [0, 0]
    sits at an offset, so the estimators are out of the comparison."""
    f = rotated_raw_burst.shape[0]
    st = jlogpolar.SimilarityTransform(
        rotation=jnp.asarray(np.asarray(CITY_ANGLES[1:], np.float32)),
        scale=jnp.ones(f - 1, jnp.float32),
        translation=jnp.asarray(
            np.random.default_rng(1).uniform(-2, 2, (f - 1, 2)).astype(np.float32)
        ),
        response=jnp.ones(f - 1, jnp.float32),
    )
    override = (st, (4, 8), (72, 144))
    want = nn(
        jax.jit(lambda r: jax_handheld_superres_raw(r, to_jax(RAW_BENCH), prealign_override=override))(
            jnp.asarray(rotated_raw_burst)
        )
    )
    port_st = similarity_from_numpy(jax.tree_util.tree_map(np.asarray, st))
    got = nn(
        handheld_superres_raw(
            tt(rotated_raw_burst), RAW_BENCH, prealign_override=(port_st, (4, 8), (72, 144)),
            device="cpu",
        )
    )
    assert psnr(got, want) >= 60.0


def test_raw_slice_noise_gate(raw_burst, monkeypatch):
    """The restore gate's statistic and gain on the slice's burst, apart:
    the statistic the pipeline computes matches the JAX function on the
    same registered luma and residual, and sits far below the gate's lower
    threshold (0.014), so the gain is 1 (measured 0.0022)."""
    seen = []

    def recording_stat(gray, residual):
        seen.append((gray, residual))
        return restore.temporal_noise_stat(gray, residual=residual)

    monkeypatch.setattr(handheld, "temporal_noise_stat", recording_stat)
    handheld_superres_raw(tt(raw_burst), RAW_SLICE, device="cpu")
    (gray, res), = seen
    stat = restore.temporal_noise_stat(gray, residual=res)
    want = jrestore.temporal_noise_stat(jnp.asarray(nn(gray)), residual=jnp.asarray(nn(res)))
    np.testing.assert_allclose(float(stat), float(want), rtol=1e-5)
    assert float(stat) < 0.5 * RAW_SLICE.restore_gate_lo
    gain = restore.restore_gain(stat, RAW_SLICE.restore_gate_lo, RAW_SLICE.restore_gate_hi)
    assert float(gain) == 1.0


def test_raw_slice_without_restore_and_lk(raw_burst):
    """The branches the default skips: no restore, no LK, block-repeated
    residual, sRGB gamma."""
    cfg = dataclasses.replace(
        RAW_SLICE, final_restore=False, use_lk=False, smooth_residual=False, gamma=True
    )
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw_burst), to_jax(cfg)))
    got = nn(handheld_superres_raw(tt(raw_burst), cfg, device="cpu"))
    assert psnr(got, want) >= 60.0


def test_raw_entry_point_raises_without_card_unless_cpu_is_asked(raw_burst, monkeypatch):
    """No card and no device request: handheld_superres_raw raises rather
    than run on the CPU, and names device="cpu"; with that request it runs
    there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        handheld_superres_raw(tt(raw_burst), RAW_SLICE)
    assert handheld_superres_raw(tt(raw_burst), RAW_SLICE, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")], ids=["str", "torch.device"])
def test_raw_cpu_request_equals_the_former_cpu_result(raw_burst, device):
    """Asked for the CPU, the entry point runs what it ran on a CPU tensor
    before it took a device (its body, _handheld_raw_fast): bit for bit."""
    want = handheld._handheld_raw_fast(tt(raw_burst), RAW_SLICE)
    got = handheld_superres_raw(tt(raw_burst), RAW_SLICE, device=device)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "cfg,knob",
    [
        (
            dataclasses.replace(
                RAW_BENCH,
                prealign_cfg=dataclasses.replace(PREALIGN_FAST, logpolar_interp="lanczos"),
            ),
            "prealign",
        ),
        (dataclasses.replace(RAW_SLICE, merge=MergeConfig(solver="newton")), "solver"),
    ],
)
def test_unsupported_raw_knobs_raise(cfg, knob):
    with pytest.raises(ValueError, match=knob):
        handheld_superres_raw(torch.zeros((2, 32, 32)), cfg)


@pytest.mark.parametrize(
    "merge,extra",
    [
        (MergeConfig(), dict(use_consistency=True, warp_matmul=False)),
        (MergeConfig(), dict(warp_matmul=False)),
        (MergeConfig(order=0, bf16=True), {}),
        (MergeConfig(centroid_cert=True, centroid_block=True), {}),
        (MergeConfig(exact_weights=True), {}),
        (MergeConfig(guided_rb=True, centroid_cert=True, exact_weights=True), {}),
        (MergeConfig(centroid_cert=True, centroid_shared_res=True), {}),
        (MergeConfig(centroid_cert=True, centroid_prune=1.0), {}),
        (MergeConfig(centroid_cert=True, centroid_bf16=True), {}),
    ],
    ids=["consistent-onehot", "onehot", "order0-bf16", "block", "exact_weights", "guided-cert-exact_weights",
         "shared_res", "prune", "centroid_bf16"],
)
def test_raw_knobs_match_jax_pipeline(raw_burst, merge, extra):
    """The merge and warp knobs the port used to refuse, on the
    configurations that tested the refusal, against the jitted JAX
    pipeline: F = 4 at 128 x 256 RAW. Measured 97.8, 81.4, 67.2, 81.4,
    85.4, 86.0, 75.3, 81.3 and 81.1 dB; the gap of the float32 ones is
    LK's bf16 window sums (ROADMAP Queue 3), as on RAW_PORT_DEFAULT's 81
    dB. The bfloat16 merges alone are the jitted JAX functions' bit for
    bit (order 0) and within float32 rounding (the centroid's products;
    test_torch_knob_merge.py); end to end they are held to
    torch_parity.bf16_limit (60 dB here: JAX's one-ulp spread less 6.02
    dB is higher), the others to the slice's 60 dB."""
    cfg = dataclasses.replace(RAW_SLICE, merge=merge, **extra)
    check_supported_raw(cfg)

    def jax_fn(x):
        return nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(x), to_jax(cfg)))

    want = jax_fn(raw_burst)
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw_burst), cfg, device="cpu"))
    assert got.shape == (256, 512, 3) and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert not LAUNCHES
    bf16 = (merge.bf16 and merge.order == 0) or merge.centroid_bf16
    assert psnr(got, want) >= (bf16_limit(jax_fn, raw_burst, want) if bf16 else 60.0)


@pytest.mark.parametrize("shape", [(1, 32, 32), (2, 31, 32), (2, 32)])
def test_raw_burst_shape_is_checked(shape):
    with pytest.raises(ValueError):
        handheld_superres_raw(torch.zeros(shape), RAW_SLICE)
