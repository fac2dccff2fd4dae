"""The ported slice end to end: handheld_superres on an RGB burst under
HandheldConfig(prealign=False, merge=MergeConfig(use_pallas=True)), and
under config.RGB_PALLAS (global pre-alignment on) on a burst rotated as
the city burst is, against the jitted JAX pipeline with its Pallas merge
interpreted."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import bf16_limit, nn, psnr, to_jax, tt

from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres as jax_handheld_superres,
)
from multi_frame_super_resolution_tpu.utils.debug import interpret_pallas
from multi_frame_super_resolution_tpu_torch.config import (
    PORT_DEFAULT,
    PREALIGN_FAST,
    RGB_PALLAS,
    AlignConfig,
    HandheldConfig,
    LKConfig,
    MergeConfig,
    check_supported,
)
from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models import handheld
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres

SLICE = HandheldConfig(prealign=False, merge=MergeConfig(use_pallas=True))


def test_port_default_is_the_slice():
    assert PORT_DEFAULT == SLICE
    check_supported(SLICE)


def test_slice_matches_jax_pipeline():
    """F = 4 at 64 x 128, motion of up to 2.5 px. The two pipelines agree
    to f32 rounding (>100 dB here); 60 dB leaves room for a rare argmin
    or bf16 window-sum step landing the other way."""
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    with interpret_pallas():
        want = nn(jax.jit(jax_handheld_superres, static_argnums=1)(jnp.asarray(burst), to_jax(SLICE)))
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst), SLICE, device="cpu"))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert LAUNCHES["merge_fast"] == 0  # CPU tensors take the plain merge
    assert psnr(got, want) >= 60.0


def test_rgb_pallas_matches_jax_pipeline():
    """Pre-alignment on: F = 5 at 64 x 128, frames rotated 0/0/5/10/-15
    degrees. The port estimates the similarities itself; they agree with
    JAX's exactly here, and the validity mask rides through the tile warp
    as a 4th channel (measured 101.0 dB). 60 dB as for the slice."""
    check_supported(RGB_PALLAS)
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 5, 64, 128, 2.5, angles=CITY_ANGLES)
    with interpret_pallas():
        want = nn(jax.jit(jax_handheld_superres, static_argnums=1)(jnp.asarray(burst), to_jax(RGB_PALLAS)))
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst), RGB_PALLAS, device="cpu"))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert not LAUNCHES
    assert psnr(got, want) >= 60.0


@pytest.mark.parametrize(
    "cfg,knob",
    [
        (
            dataclasses.replace(
                RGB_PALLAS,
                prealign_cfg=dataclasses.replace(PREALIGN_FAST, logpolar_interp="lanczos"),
            ),
            "prealign",
        ),
        (dataclasses.replace(SLICE, fast=False, use_consistency=True, merge=MergeConfig(solver="newton")), "solver"),
        (HandheldConfig(prealign=False, merge=MergeConfig(rgb_order=1, solver="newton")), "solver"),
        (dataclasses.replace(SLICE, merge=MergeConfig(use_pallas=True, rgb_order=1)), "use_pallas"),
    ],
)
def test_unsupported_knobs_raise(cfg, knob):
    with pytest.raises(ValueError, match=knob):
        handheld_superres(torch.zeros((2, 32, 32, 3)), cfg)


@pytest.mark.parametrize(
    "cfg",
    [
        dataclasses.replace(SLICE, use_consistency=True, warp_matmul=False),
        dataclasses.replace(SLICE, rgb_half_stats=True),
        dataclasses.replace(SLICE, warp_matmul=False),
        HandheldConfig(prealign=False, merge=MergeConfig(bf16=True)),
        dataclasses.replace(SLICE, align=AlignConfig(use_fft=True), rgb_half_stats=True),
        HandheldConfig(prealign=False, lk=LKConfig(warp_tile=16), merge=MergeConfig(bf16=True)),
    ],
    ids=["consistent-onehot", "half_stats", "onehot", "bf16", "fft-half_stats", "warp_tile-bf16"],
)
def test_knobs_match_jax_pipeline(cfg):
    """The knobs the port used to refuse, on the configurations that
    tested the refusal: the one-hot tile warp (warp_matmul=False), LK and
    robustness at half resolution (rgb_half_stats) and the default
    branch's bfloat16 order-0 merge (merge.bf16), F = 4 at 64 x 128
    against the jitted JAX pipeline. Measured 120.1, 122.1, 122.0, 77.5,
    120.0 and 77.6 dB. The bfloat16 merges are held to
    torch_parity.bf16_limit, which JAX's own one-ulp spread sets there:
    60 dB (the spread less 6.02 dB is higher); their merge alone is the
    JAX function's bit for bit (test_torch_knob_merge.py)."""
    check_supported(cfg)
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)

    def jax_fn(x):
        with interpret_pallas():
            return nn(jax.jit(jax_handheld_superres, static_argnums=1)(jnp.asarray(x), to_jax(cfg)))

    want = jax_fn(burst)
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst), cfg, device="cpu"))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert not LAUNCHES
    assert psnr(got, want) >= (bf16_limit(jax_fn, burst, want) if cfg.merge.bf16 else 60.0)


def test_slice_windows_branch_matches_jax_pipeline():
    """The RGB slice with the per-tile search windows of the alignment
    (align.fast_extract=False), now supported by the port."""
    cfg = dataclasses.replace(SLICE, align=AlignConfig(fast_extract=False))
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    with interpret_pallas():
        want = nn(jax.jit(jax_handheld_superres, static_argnums=1)(jnp.asarray(burst), to_jax(cfg)))
    got = nn(handheld_superres(tt(burst), cfg, device="cpu"))
    assert psnr(got, want) >= 60.0


def test_entry_point_raises_without_card_unless_cpu_is_asked(monkeypatch):
    """No card and no device request: handheld_superres raises rather than
    run on the CPU, and names device="cpu"; with that request it runs
    there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        handheld_superres(tt(burst), SLICE)
    assert handheld_superres(tt(burst), SLICE, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")], ids=["str", "torch.device"])
def test_cpu_request_equals_the_former_cpu_result(device):
    """Asked for the CPU, the entry point runs what it ran on a CPU tensor
    before it took a device (its body, _handheld_fast): bit for bit."""
    burst = tt(synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)[0])
    want = handheld._handheld_fast(burst, SLICE)
    torch.testing.assert_close(handheld_superres(burst, SLICE, device=device), want, rtol=0, atol=0)


def test_port_never_imports_jax():
    """In a fresh interpreter: every module of the port (the parallel
    layer and the native reader's binding among them), chip_smoke.py and
    the modules its main() imports load neither jax nor any module of
    the JAX package, nor Pillow (PIL), which the GPU host lacks."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_frame_super_resolution_tpu_torch as port\n"
        "for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'multi_frame_super_resolution_tpu'\n"
        "       or m.startswith('multi_frame_super_resolution_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'PIL' not in sys.modules and not any(m.startswith('PIL.') for m in sys.modules)\n"
        "assert 'multi_frame_super_resolution_tpu_torch.apps.polar_defog' in sys.modules\n"
        "assert {'multi_frame_super_resolution_tpu_torch.parallel.' + m for m in ('mesh', 'runner', 'spatial')} <= set(sys.modules)\n"
        "assert 'multi_frame_super_resolution_tpu_torch.data.native' in sys.modules\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)
