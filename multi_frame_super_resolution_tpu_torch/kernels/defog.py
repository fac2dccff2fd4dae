"""Wrapper of the Hopper defog kernel (csrc/defog.cu), the counterpart of
pallas_ops/defog.py::defog_pallas, and its plain PyTorch version
``defog_pixels``.

On CUDA tensors ``defog`` launches the kernel or raises; it never falls
back. On CPU tensors it computes ``defog_pixels``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.build import (
    bind,
    check_tensor,
    launch,
    load_library,
)

NAME = "defog"
SOURCE = "defog.cu"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return bind(
        load_library(SOURCE), "mfsr_defog",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_float] * 4,
    )


def defog_pixels(
    iper: torch.Tensor, ipar: torch.Tensor, p: torch.Tensor, ainfi: torch.Tensor,
    t_min: float = 0.001, t_max: float = 0.999, r_min: float = 0.001, r_max: float = 0.999,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per pixel and channel: A = (Iper - Ipar) / P,
    t = clip(1 - A / A_inf, t_min, t_max), R = clip((Iper + Ipar - A) / t,
    r_min, r_max). iper, ipar (H, W, 3); p, ainfi (3,). Returns (A, t, R)."""
    a = (iper - ipar) / p
    t = (1.0 - a / ainfi).clamp(t_min, t_max)
    r = ((iper + ipar - a) / t).clamp(r_min, r_max)
    return a, t, r


def defog(
    iper: torch.Tensor, ipar: torch.Tensor, p: torch.Tensor, ainfi: torch.Tensor,
    t_min: float = 0.001, t_max: float = 0.999, r_min: float = 0.001, r_max: float = 0.999,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function of ``defog_pixels``: iper, ipar (H, W, 3) float32 and
    p, ainfi (3,) float32, all contiguous on one device. Returns (A, t, R),
    each (H, W, 3)."""
    if iper.ndim != 3 or iper.shape[-1] != 3:
        raise ValueError(f"iper must be (H, W, 3), got {tuple(iper.shape)}")
    dev = iper.device
    check_tensor("iper", iper, iper.shape, dev)
    check_tensor("ipar", ipar, iper.shape, dev)
    check_tensor("p", p, (3,), dev)
    check_tensor("ainfi", ainfi, (3,), dev)
    if dev.type == "cpu":
        return defog_pixels(iper, ipar, p, ainfi, t_min, t_max, r_min, r_max)
    n = iper.numel()
    if n >= 2**31:
        raise ValueError(f"the defog kernel takes fewer than 2^31 elements, got {n}")
    a, t, r = (torch.empty_like(iper) for _ in range(3))
    launch(
        library(), "mfsr_defog", dev,
        iper.data_ptr(), ipar.data_ptr(), p.data_ptr(), ainfi.data_ptr(),
        a.data_ptr(), t.data_ptr(), r.data_ptr(), n,
        float(t_min), float(t_max), float(r_min), float(r_max),
    )
    LAUNCHES[NAME] += 1
    return a, t, r
