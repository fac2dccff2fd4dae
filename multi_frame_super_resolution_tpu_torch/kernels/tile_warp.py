"""Wrapper of the Hopper tile-warp kernel (csrc/tile_warp.cu), the
counterpart of pallas_ops/tile_warp.py::tile_warp_pallas.

One kernel, three index maps:

- ``tile_warp`` (separable map): the function the pipelines run by
  default, ops/warp_fast.py::tile_warp_matmul (shifts clipped to +-bound,
  the y-shift read from the source column's tile); with ``onehot=True``
  (one-hot map) the function of ops/warp_fast.py::tile_warp_select, the
  pipelines' warp_matmul=False: a row pass, then a column pass, each with
  the one-hot form's two-level indexing past a 13-wide window;
- ``tile_warp_block`` (block map): tile_warp_pallas's own function, a
  block copy per tile with the block origin clamped into the image.

On CUDA tensors each launches the kernel or raises; it never falls back.
On CPU tensors each computes its plain PyTorch version
(ops/warp_fast.py::tile_warp_matmul, tile_warp_select, tile_warp_block).
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
from multi_frame_super_resolution_tpu_torch.ops import warp_fast
from multi_frame_super_resolution_tpu_torch.registration.tiles import tile_counts

NAME = "tile_warp"
SOURCE = "tile_warp.cu"
SEPARABLE, BLOCK, ONEHOT = 0, 1, 2  # csrc/tile_warp.cu's index maps


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return bind(
        load_library(SOURCE), "mfsr_tile_warp",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_uint64],
    )


def floor_magic(coarse: int, bound: int) -> tuple:
    """(k, m) of csrc/tile_warp.cu's floor division by ``coarse`` (>= 2)
    for shifts v in [-bound, bound]: floor(v / c) = (((v + c k) m) >> 64)
    - k, with k = ceil(bound / c), so that v + c k >= 0, and m =
    ceil(2^64 / c)."""
    return -(-bound // coarse), -(-(1 << 64) // coarse)


def _warp(imgs, int_shifts, tile_size, bound, index_map):
    if imgs.ndim != 4:
        raise ValueError(f"imgs must be (B, N, H, W), got {tuple(imgs.shape)}")
    b, n, h, w = imgs.shape
    dev = imgs.device
    nty, ntx = tile_counts(h, w, tile_size)
    check_tensor("imgs", imgs, (b, n, h, w), dev)
    check_tensor("int_shifts", int_shifts, (b, nty, ntx, 2), dev, torch.int32)
    if index_map == BLOCK and (h % tile_size or w % tile_size):
        raise ValueError(f"the block map needs H and W multiples of {tile_size}, got {h}x{w}")
    if dev.type == "cpu":
        if index_map == BLOCK:
            return warp_fast.tile_warp_block(imgs, int_shifts, tile_size)
        if index_map == ONEHOT:
            return warp_fast.tile_warp_select(imgs, int_shifts[:, None], tile_size, bound)
        return warp_fast.tile_warp_matmul(imgs, int_shifts, tile_size, bound)
    coarse = warp_fast.onehot_coarse(int(bound)) if index_map == ONEHOT else 0
    offset, magic = floor_magic(coarse, int(bound)) if coarse else (0, 0)
    out = torch.empty_like(imgs)
    launch(
        library(), "mfsr_tile_warp", dev,
        imgs.data_ptr(), int_shifts.data_ptr(), out.data_ptr(),
        b, n, h, w, tile_size, nty, ntx, int(bound), index_map, offset, magic,
    )
    LAUNCHES[NAME] += 1
    return out


def tile_warp(
    imgs: torch.Tensor, int_shifts: torch.Tensor, tile_size: int, bound: int = 16, onehot: bool = False
) -> torch.Tensor:
    """Separable per-tile integer warp (the function of tile_warp_matmul,
    or with ``onehot`` of tile_warp_select): imgs (B, N, H, W) float32, N
    planes sharing the shift field of their batch entry; int_shifts
    (B, nty, ntx, 2) int32 over the ceil-divided tile grid; both
    contiguous on one device. Returns (B, N, H, W)."""
    return _warp(imgs, int_shifts, tile_size, bound, ONEHOT if onehot else SEPARABLE)


def tile_warp_block(imgs: torch.Tensor, int_shifts: torch.Tensor, tile_size: int) -> torch.Tensor:
    """Block per-tile copy (the function of tile_warp_pallas): imgs
    (B, N, H, W) float32 with H and W multiples of the tile size;
    int_shifts (B, nty, ntx, 2) int32, not clipped. Returns (B, N, H, W)."""
    return _warp(imgs, int_shifts, tile_size, 0, BLOCK)
