"""Tests of the port that need the card: the Hopper merge kernel against
its plain PyTorch version, and the slice on the card against the port on
the CPU. They skip without a CUDA device.

This file imports no JAX, so the GPU host (which has none) runs it
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from torch_parity import cuda_device, nn, psnr, tt

from multi_frame_super_resolution_tpu_torch.config import PORT_DEFAULT
from multi_frame_super_resolution_tpu_torch.data import synthetic_rgb_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast
from multi_frame_super_resolution_tpu_torch.models import fast_merge
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres


def _merge_inputs(rng, f, h, w):
    warped = rng.random((f, h, w, 3)).astype(np.float32)
    residual = (rng.random((f, h, w, 2)) * 2.0 - 1.0).astype(np.float32)
    certainty = rng.random((f, h, w, 3)).astype(np.float32)
    omega = (0.5 + rng.random((h, w, 3))).astype(np.float32)
    omega[..., 2] *= 0.1
    return warped, residual, certainty, omega


@pytest.mark.cuda
@pytest.mark.parametrize(
    "f,h,w,scale,radius",
    [(5, 64, 96, 2, 1), (3, 20, 37, 1, 1), (2, 33, 40, 3, 2), (2, 24, 24, 4, 1)],
)
def test_merge_kernel_matches_plain(f, h, w, scale, radius):
    """Any H and W, scales 1-4. expf and FMA contraction differ from the
    plain ops by a few ulps: rtol and atol 1e-5."""
    dev = cuda_device()
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(1), f, h, w)]
    LAUNCHES.clear()
    num, den = merge_fast(*ins, scale, radius, 1.0, 1.0)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_fast"] == 1
    num_p, den_p = fast_merge.merge_burst_fast(*ins, scale, radius, 1.0, 1.0)
    torch.testing.assert_close(num, num_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(den, den_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_merge_wrapper_raises_on_card_for_bad_input():
    dev = cuda_device()
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(1), 2, 8, 8)]
    with pytest.raises(ValueError):
        merge_fast(ins[0], ins[1].cpu(), ins[2], ins[3], 2, 1, 1.0, 1.0)


@pytest.mark.cuda
def test_slice_on_card_matches_cpu():
    """The slice on the card (merge kernel included) against the same port
    on the CPU (plain merge); TF32 is off, so both run in float32."""
    dev = cuda_device()
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    want = nn(handheld_superres(tt(burst), PORT_DEFAULT))
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst, dev), PORT_DEFAULT))
    assert LAUNCHES["merge_fast"] == 1
    assert psnr(got, want) >= 60.0
