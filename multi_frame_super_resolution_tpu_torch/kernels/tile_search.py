"""Wrapper of the Hopper tile search kernel (csrc/tile_search.cu), the
counterpart of pallas_ops/tile_gather.py::tile_gather_pallas fused with
the SSD surface, the argmin and the subpixel step that consume its
windows: one launch per pyramid level of align_frames, on both branches.
The templated kernel takes tile sizes 8, 16 and 32 and radii from 1 to
what 48 KB of shared memory hold; the general kernel takes every other
tile size and radius (uses_general), staged as search_plan says, its
launches counted under ``tile_search_general``.

On CUDA tensors it launches the kernel or raises; it never falls back.
On CPU tensors it computes the plain PyTorch version,
registration/tiles.py::tile_search.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

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
_THREADS = 256  # kThreads: a general block
_GV = 4  # kGV: consecutive offsets of a general work item
_SMEM_MAX = 232448  # the shared memory a block can opt in to (sm_90)


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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 7,
    )


class SearchPlan(NamedTuple):
    """The general search's staging (csrc/tile_search.cu's SearchPlan): a
    stage holds ``bu`` offset rows and ``bt`` tile rows; ``split``:
    (offsets, tile row) items; ``surf_smem``: the surface in shared
    memory; ``smem``: the bytes."""

    bu: int
    bt: int
    split: bool
    surf_smem: bool
    smem: int


def search_floats(t: int, radius: int, bu: int, bt: int, split: bool, surf_smem: bool) -> int:
    """A transcription of csrc/tile_search.cu's general_floats: the tile
    band (bt x T), the window band (bu + bt - 1 rows of the offsets' kGV
    groups plus T - 1 columns, odd stride), the rows' sums (split) and the
    surface (surf_smem)."""
    s_n = 2 * radius + 1
    n_v = -(-s_n // _GV) * _GV
    stride = (n_v + t - 1) | 1
    return bt * t + (bu + bt - 1) * stride + (bt * bu * n_v if split else 0) + (s_n * s_n if surf_smem else 0)


@functools.lru_cache(maxsize=None)
def search_plan(tile_size: int, radius: int) -> Optional[SearchPlan]:
    """The general search's staging at tile size T and radius R (s_n = 2R
    + 1 offsets a side), within 232,448 bytes of shared memory:

    - split where the offset items (s_n rows of ceil(s_n / 4) groups of 4
      offsets) would leave more than half the block's 256 threads idle
      (radii up to 10): an item is then (offsets, tile row), the rows
      summed after;
    - the whole window and tile (bu = s_n, bt = T), with the surface in
      shared memory where it fits beside them, else in device scratch;
    - else bands: bt tile rows at a time and bu offset rows at a time,
      the surface in shared memory where some band fits beside it, each
      choice the one that stages the fewest floats over the launch.

    None where not even one tile row and one offset row fit (T + R past
    ~29,000)."""
    t, s_n = tile_size, 2 * radius + 1
    split = 2 * s_n * -(-s_n // _GV) <= _THREADS
    budget = _SMEM_MAX // 4  # floats

    def floats(bu, bt, surf):
        return search_floats(t, radius, bu, bt, split, surf)

    for surf in (True, False):
        if floats(s_n, t, surf) <= budget:
            return SearchPlan(s_n, t, split, surf, 4 * floats(s_n, t, surf))
    n_v = -(-s_n // _GV) * _GV
    for surf in (True, False):
        best = None
        for bt in range(min(t, budget), 0, -1):
            # floats() grows by this much an offset row: solve for the most that fit
            per_row = floats(2, bt, surf) - floats(1, bt, surf)
            bu = min(s_n, (budget - floats(1, bt, surf)) // per_row + 1)
            if bu < 1:
                continue
            stages = -(-s_n // bu) * -(-t // bt)
            staged = stages * (bt * t + (bu + bt - 1) * (n_v + t - 1))
            if best is None or staged < best[0]:
                best = (staged, bu, bt)
        if best is not None:
            _, bu, bt = best
            return SearchPlan(bu, bt, split, surf, 4 * floats(bu, bt, surf))
    return None


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
        plan = search_plan(tile_size, radius)
        if plan is None:
            raise ValueError(f"the tile search stages at least one tile row and one offset row of its window "
                             f"in 232,448 bytes of shared memory: tile size {tile_size} with radius {radius} "
                             "does not fit")
        surf = None
        if not plan.surf_smem:
            surf = torch.empty((n, nty, ntx, (2 * radius + 1) ** 2), dtype=torch.float32, device=dev)
        launch(lib, "mfsr_tile_search_general", dev, ref.data_ptr(), alts.data_ptr(), rounded.data_ptr(),
               out.data_ptr(), None if surf is None else surf.data_ptr(), *args, plan.bu, plan.bt,
               int(plan.split), int(plan.surf_smem), plan.smem)
        LAUNCHES[GENERAL] += 1
        return out
    launch(lib, "mfsr_tile_search", dev, ref.data_ptr(), alts.data_ptr(), rounded.data_ptr(),
           out.data_ptr(), *args)
    LAUNCHES[NAME] += 1
    return out
