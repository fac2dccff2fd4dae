"""Wrapper of the Hopper tile search kernel (csrc/tile_search.cu), the
counterpart of pallas_ops/tile_gather.py::tile_gather_pallas fused with
the SSD surface, the argmin and the subpixel step that consume its
windows: one launch per pyramid level of align_frames, on both branches.

On CUDA tensors it launches the kernel or raises; it never falls back.
On CPU tensors it computes the plain PyTorch version,
registration/tiles.py::tile_search.
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
from multi_frame_super_resolution_tpu_torch.registration import tiles

NAME = "tile_search"
SOURCE = "tile_search.cu"
MODES = ("image", "tile")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = bind(
        load_library(SOURCE), "mfsr_tile_search",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2,
    )
    lib.mfsr_tile_search_max_radius.argtypes = [ctypes.c_int]
    lib.mfsr_tile_search_max_radius.restype = ctypes.c_int
    return lib


def tile_search(
    ref: torch.Tensor,
    alts: torch.Tensor,
    rounded: torch.Tensor,
    tile_size: int,
    radius: int,
    threshold: float = 0.0,
    subpixel: bool = True,
    mode: str = "image",
) -> torch.Tensor:
    """One pyramid level of the tile search (see tiles.tile_search): ref
    (H, W), alts (N, H, W) and rounded (N, nty, ntx, 2) over the
    ceil-divided tile grid, all float32 and contiguous on one device ->
    rounded + the found shift, (N, nty, ntx, 2). The kernel takes tile
    sizes 8, 16 and 32 and radii from 1 up to what its shared memory holds
    (mfsr_tile_search_max_radius); on CUDA tensors anything else raises
    ValueError."""
    if alts.ndim != 3:
        raise ValueError(f"alts must be (N, H, W), got {tuple(alts.shape)}")
    n, h, w = alts.shape
    dev = alts.device
    nty, ntx = tiles.tile_counts(h, w, tile_size)
    check_tensor("ref", ref, (h, w), dev)
    check_tensor("alts", alts, (n, h, w), dev)
    check_tensor("rounded", rounded, (n, nty, ntx, 2), dev)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    if dev.type == "cpu":
        return tiles.tile_search(ref, alts, rounded, tile_size, radius, threshold, subpixel, mode)
    lib = library()
    max_radius = lib.mfsr_tile_search_max_radius(tile_size)
    if max_radius < 0:
        raise ValueError(f"the tile search kernel takes tile sizes 8, 16 and 32, got {tile_size}")
    if not 1 <= radius <= max_radius:
        raise ValueError(
            f"the tile search kernel takes radii 1..{max_radius} at tile size {tile_size} "
            f"(its windows' shared memory), got {radius}"
        )
    out = torch.empty_like(rounded)
    launch(
        lib, "mfsr_tile_search", dev,
        ref.data_ptr(), alts.data_ptr(), rounded.data_ptr(), out.data_ptr(),
        n, h, w, tile_size, radius, float(threshold), int(subpixel), int(mode == "image"),
    )
    LAUNCHES[NAME] += 1
    return out
