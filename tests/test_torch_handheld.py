"""The ported slice end to end: handheld_superres on an RGB burst under
HandheldConfig(prealign=False, merge=MergeConfig(use_pallas=True)),
against the jitted JAX pipeline with its Pallas merge interpreted."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, psnr, tt

from multi_frame_super_resolution_tpu.config import (
    AlignConfig,
    HandheldConfig,
    LKConfig,
    MergeConfig,
)
from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres as jax_handheld_superres,
)
from multi_frame_super_resolution_tpu.utils.debug import interpret_pallas
from multi_frame_super_resolution_tpu_torch.config import PORT_DEFAULT, check_supported
from multi_frame_super_resolution_tpu_torch.data import synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
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
        want = nn(jax.jit(jax_handheld_superres, static_argnums=1)(jnp.asarray(burst), SLICE))
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst), SLICE))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert LAUNCHES["merge_fast"] == 0  # CPU tensors take the plain merge
    assert psnr(got, want) >= 60.0


@pytest.mark.parametrize(
    "cfg,knob",
    [
        (HandheldConfig(), "prealign"),
        (dataclasses.replace(SLICE, fast=False), "fast"),
        (dataclasses.replace(SLICE, use_consistency=True), "use_consistency"),
        (dataclasses.replace(SLICE, rgb_half_stats=True), "rgb_half_stats"),
        (dataclasses.replace(SLICE, warp_matmul=False), "warp_matmul"),
        (HandheldConfig(prealign=False), "use_pallas"),
        (dataclasses.replace(SLICE, merge=MergeConfig(use_pallas=True, rgb_order=1)), "rgb_order"),
        (dataclasses.replace(SLICE, align=AlignConfig(use_fft=True)), "use_fft"),
        (dataclasses.replace(SLICE, align=AlignConfig(fast_extract=False)), "fast_extract"),
        (dataclasses.replace(SLICE, lk=LKConfig(warp_tile=16)), "warp_tile"),
    ],
)
def test_unsupported_knobs_raise(cfg, knob):
    with pytest.raises(ValueError, match=knob):
        handheld_superres(torch.zeros((2, 32, 32, 3)), cfg)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import multi_frame_super_resolution_tpu_torch.models.handheld\n"
        "import multi_frame_super_resolution_tpu_torch.kernels.merge\n"
        "import multi_frame_super_resolution_tpu_torch.kernels.build\n"
        "import multi_frame_super_resolution_tpu_torch.data\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
