"""Wrapper of the Hopper tile-window kernel (csrc/tile_gather.cu), the
counterpart of pallas_ops/tile_gather.py::tile_gather_pallas.

It computes registration/tiles.py::extract_search_windows's function,
clamped per pixel: that function everywhere, and tile_gather_pallas's
(which clamps whole blocks) on interior tiles.

On CUDA tensors it launches the kernel or raises; it never falls back.
On CPU tensors it computes the plain PyTorch version,
registration/tiles.py::extract_search_windows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.build import (
    bind,
    check_tensor,
    launch,
    load_library,
)
from multi_frame_super_resolution_tpu_torch.registration.tiles import (
    extract_search_windows,
    tile_counts,
)

NAME = "tile_gather"
SOURCE = "tile_gather.cu"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return bind(
        load_library(SOURCE), "mfsr_tile_gather",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7,
    )


def tile_gather(
    imgs: torch.Tensor, int_shifts: torch.Tensor, tile_size: int, pad: int
) -> torch.Tensor:
    """Per-tile search windows: imgs (N, H, W) float32, int_shifts
    (N, nty, ntx, 2) int32 over the ceil-divided tile grid, both
    contiguous on one device -> (N, nty, ntx, T+2p, T+2p) with
    out[n, ty, tx, u, v] = img[n, clip(ty*T + sy + u - p, 0, H-1),
    clip(tx*T + sx + v - p, 0, W-1)]."""
    if imgs.ndim != 3:
        raise ValueError(f"imgs must be (N, H, W), got {tuple(imgs.shape)}")
    n, h, w = imgs.shape
    dev = imgs.device
    nty, ntx = tile_counts(h, w, tile_size)
    check_tensor("imgs", imgs, (n, h, w), dev)
    check_tensor("int_shifts", int_shifts, (n, nty, ntx, 2), dev, torch.int32)
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    if dev.type == "cpu":
        return extract_search_windows(imgs, tile_size, pad, int_shifts)
    t2 = tile_size + 2 * pad
    out = torch.empty((n, nty, ntx, t2, t2), dtype=torch.float32, device=dev)
    launch(
        library(), "mfsr_tile_gather", dev,
        imgs.data_ptr(), int_shifts.data_ptr(), out.data_ptr(),
        n, h, w, tile_size, pad, nty, ntx,
    )
    LAUNCHES[NAME] += 1
    return out
