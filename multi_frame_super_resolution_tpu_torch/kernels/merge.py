"""Wrapper of the Hopper merge kernel (csrc/merge.cu), the counterpart of
pallas_ops/merge.py::merge_fast_pallas.

On CUDA tensors it launches the kernel or raises; it never falls back.
On CPU tensors it computes the kernel's plain PyTorch version,
models/fast_merge.py::merge_burst_fast, with the same taps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.models.fast_merge import (
    _active_taps,
    merge_burst_fast,
)

NAME = "merge_fast"
SOURCE = "merge.cu"
_MAX_TAP_RADIUS = 8  # kMaxTaps in csrc/merge.cu


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    from multi_frame_super_resolution_tpu_torch.kernels.build import load_library

    lib = load_library(SOURCE)
    lib.mfsr_merge_fast.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.mfsr_merge_fast.restype = ctypes.c_int
    lib.mfsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mfsr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def merge_fast(
    warped: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order-0 static-tap merge: warped (F, H, W, 3), residual (F, H, W, 2),
    certainty (F, H, W, 3), omega_inv (H, W, 3), all float32 and
    contiguous on one device -> (num, den), each (sH, sW, 3). Taps are
    those of fast_merge._active_taps, as in merge_fast_pallas."""
    if warped.ndim != 4:
        raise ValueError(f"warped must be (F, H, W, 3), got {tuple(warped.shape)}")
    f, h, w = warped.shape[:3]
    dev = warped.device
    _check("warped", warped, (f, h, w, 3), dev)
    _check("residual", residual, (f, h, w, 2), dev)
    _check("certainty", certainty, (f, h, w, 3), dev)
    _check("omega_inv", omega_inv, (h, w, 3), dev)
    if not 1 <= scale <= 4:
        raise ValueError(f"the merge kernel takes scale 1..4, got {scale}")
    r_taps = radius + int(np.ceil(residual_bound))
    if r_taps > _MAX_TAP_RADIUS:
        raise ValueError(f"tap radius {r_taps} exceeds the kernel's {_MAX_TAP_RADIUS}")

    if dev.type == "cpu":
        return merge_burst_fast(
            warped, residual, certainty, omega_inv, scale, radius,
            residual_bound, k_max,
        )
    if dev.type != "cuda":
        raise ValueError(f"merge_fast runs on cpu or cuda tensors, got {dev}")

    taps = np.asarray(_active_taps(r_taps, residual_bound, scale, k_max), np.int32)
    taps_c = np.ascontiguousarray(taps.reshape(-1))
    num = torch.empty((h * scale, w * scale, 3), dtype=torch.float32, device=dev)
    den = torch.empty_like(num)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mfsr_merge_fast(
            warped.data_ptr(), residual.data_ptr(), certainty.data_ptr(),
            omega_inv.data_ptr(), num.data_ptr(), den.data_ptr(),
            f, h, w, scale, taps_c.ctypes.data, len(taps), float(residual_bound),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"merge kernel launch failed: {lib.mfsr_cuda_error_string(err).decode()}"
        )
    LAUNCHES[NAME] += 1
    return num, den
