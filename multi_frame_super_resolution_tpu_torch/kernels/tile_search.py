"""Wrapper of the Hopper tile search kernel (csrc/tile_search.cu), the
counterpart of pallas_ops/tile_gather.py::tile_gather_pallas fused with
the SSD surface, the argmin and the subpixel step that consume its
windows: one launch per pyramid level of align_frames, on both branches.
The templated kernel takes tile sizes 8, 16 and 32 and radii from 1 to
what 48 KB of shared memory hold; the general kernel takes every other
tile size and radius (uses_general), its launches counted under
``tile_search_general``.

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
GENERAL = "tile_search_general"  # the general kernel's launches
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
    return bind(
        lib, "mfsr_tile_search_general",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2,
    )


def uses_general(tile_size: int, radius: int, max_radius: int) -> bool:
    """Whether the general kernel runs the search: a tile size other than
    8, 16 and 32 (``max_radius`` < 0, mfsr_tile_search_max_radius's
    answer), radius 0, or a radius past ``max_radius``."""
    return max_radius < 0 or not 1 <= radius <= max_radius


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
    rounded + the found shift, (N, nty, ntx, 2). On CUDA tensors the
    templated kernel runs where it applies and the general kernel
    everywhere else (uses_general)."""
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
    if tile_size < 1:
        raise ValueError(f"tile_size must be >= 1, got {tile_size}")
    if dev.type == "cpu":
        return tiles.tile_search(ref, alts, rounded, tile_size, radius, threshold, subpixel, mode)
    lib = library()
    out = torch.empty_like(rounded)
    args = (n, h, w, tile_size, radius, float(threshold), int(subpixel), int(mode == "image"))
    if uses_general(tile_size, radius, lib.mfsr_tile_search_max_radius(tile_size)):
        surf = torch.empty((n, nty, ntx, (2 * radius + 1) ** 2), dtype=torch.float32, device=dev)
        launch(lib, "mfsr_tile_search_general", dev, ref.data_ptr(), alts.data_ptr(), rounded.data_ptr(),
               out.data_ptr(), surf.data_ptr(), *args)
        LAUNCHES[GENERAL] += 1
        return out
    launch(lib, "mfsr_tile_search", dev, ref.data_ptr(), alts.data_ptr(), rounded.data_ptr(),
           out.data_ptr(), *args)
    LAUNCHES[NAME] += 1
    return out
