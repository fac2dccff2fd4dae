"""Wrapper of the Hopper merge kernels (csrc/merge.cu), the counterpart of
pallas_ops/merge.py::merge_fast_pallas and of the default RGB branch's
merge (models/fast_merge.py::merge_burst_fast in the phase layout, order
0 in float32 or bfloat16, or the order-1 moments of the plugin solve (4)
or the exact solve (9)). The templated kernel takes scales 1-4 and taps
within +-25; its general form (S = 0, a block shape from general_tile)
every other scale and taps within +-34 (uses_general), its launches
counted under ``merge_fast_general``; past that reach, where no staged
tile fits a block's shared memory, the unstaged kernel runs
(``merge_fast_unstaged``).

On CUDA tensors it launches the kernel or raises; it never falls back.
On CPU tensors it computes the kernel's plain PyTorch version,
models/fast_merge.py::merge_burst_fast, with the same taps.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.build import (
    bind,
    check_tensor,
    launch,
    load_library,
)
from multi_frame_super_resolution_tpu_torch.models.fast_merge import (
    _active_taps,
    merge_burst_fast,
)
from multi_frame_super_resolution_tpu_torch.ops.filters import _const_array

NAME = "merge_fast"
GENERAL = "merge_fast_general"  # the general form's launches
UNSTAGED = "merge_fast_unstaged"  # the unstaged kernel's launches
SOURCE = "merge.cu"
# merge_fast_pallas's own halo (pallas_ops/merge.py:154), which the
# interleaved form (use_pallas) keeps
_PALLAS_RADIUS = 8
_MAX_TAP_RADIUS = 25  # kMaxRadius in csrc/merge.cu: the templated layouts' largest staged halo
_SMEM_MAX = 232448  # kMaxSmem: the shared memory a block can opt in to (sm_90)
_SITE_BYTES = 48  # a staged site: a float4 and a float2, in two frame buffers


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = bind(
        load_library(SOURCE), "mfsr_merge_fast",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float],
    )
    bind(
        lib, "mfsr_merge_fast_general",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 4,
    )
    return bind(
        lib, "mfsr_merge_fast_unstaged",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float],
    )


def uses_general(scale: int, halo: int) -> bool:
    """Whether the templated kernel's layouts do not take the merge: a
    scale past 4 or taps reaching past +-25 (``halo``: the largest
    |ky|, |kx| of the list). general_tile then gives the general form's
    block, or None where the unstaged kernel runs."""
    return not 1 <= scale <= 4 or halo > _MAX_TAP_RADIUS


@functools.lru_cache(maxsize=None)
def general_tile(scale: int, halo: int, form: int) -> Optional[Tuple[int, int, int, int, int]]:
    """The general form's block at ``scale`` for taps of reach ``halo`` in
    kernel form ``form``: (tile_w, tile_h, rows, groups, shared bytes), a
    thread per pixel of a tile_w x tile_h tile and phase of ``rows`` phase
    rows, grid z over the ``groups`` of rows, within the form's thread
    bound (form 3's 27 accumulators: 512, else 1024) and two frame
    buffers of the staged tile (48 B a site) within 232,448 bytes. The
    tile is 8 pixels wide (a warp reads 8 sites at 4 phases; small blocks,
    several an SM: at s = 5 it measured fastest of widths 4, 8, 16 and 32
    on an NVIDIA H100), narrower where the halo's staged row does not fit, and
    taller at scales below 3 (to 256 threads). None where not one staged
    site fits (a reach past 34): the unstaged kernel's."""
    max_threads = 512 if form == 3 else 1024

    def staged(tw, th):
        return (th + 2 * halo) * (tw + 2 * halo) * _SITE_BYTES

    tw = 8
    while tw > 1 and (staged(tw, 1) > _SMEM_MAX or tw * scale > max_threads):
        tw //= 2
    if staged(tw, 1) > _SMEM_MAX or tw * scale > max_threads:
        return None
    th = 1
    while th < 8 and staged(tw, 2 * th) <= _SMEM_MAX and tw * 2 * th * scale * scale <= 256:
        th *= 2
    rows = max(1, min(scale, max_threads // (tw * th * scale)))
    groups = -(-scale // rows)
    rows = -(-scale // groups)  # the groups evened out
    park = th * rows * tw * scale * 3 * 4 if form == 0 else 0  # form 0's parked output rows
    return tw, th, rows, groups, max(staged(tw, th), park)


def tap_array(
    r_taps: int, residual_bound: float, scale: int, k_max: float, prune_exp: float = 6.0
) -> np.ndarray:
    """The kernel's host tap list: fast_merge._active_taps as contiguous
    int32 (n, 2) rows (ky, kx), built once per key and read-only (shared
    by every call)."""
    return _tap_array(r_taps, float(residual_bound), scale, float(k_max), float(prune_exp))


@functools.lru_cache(maxsize=None)
def _tap_array(r_taps: int, residual_bound: float, scale: int, k_max: float, prune_exp: float) -> np.ndarray:
    taps = np.ascontiguousarray(
        np.asarray(
            _active_taps(r_taps, residual_bound, scale, k_max, prune_exp), np.int32
        ).reshape(-1, 2)
    )
    taps.flags.writeable = False
    return taps


def _tap_copy(*key) -> np.ndarray:
    """A writable copy of tap_array(*key), for a tensor on the card."""
    return np.array(tap_array(*key))


@functools.lru_cache(maxsize=None)
def _tap_args(
    r_taps: int, residual_bound: float, scale: int, k_max: float, prune_exp: float = 6.0
) -> Tuple[int, int]:
    """(host address, count) of tap_array's rows: what a launch passes."""
    taps = tap_array(r_taps, residual_bound, scale, k_max, prune_exp)
    return taps.ctypes.data, len(taps)


@functools.lru_cache(maxsize=None)
def _tap_reach(*key) -> int:
    """The largest |ky|, |kx| of tap_array(*key): the kernels' staged halo."""
    return int(np.abs(tap_array(*key)).max(initial=0))


def merge_fast(
    warped: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
    phase_output: bool = False,
    order: int = 0,
    prune_exp: float = 6.0,
    moment_slots: int = 4,
    bf16: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Static-tap merge: warped (F, H, W, 3), residual (F, H, W, 2),
    certainty (F, H, W, 3), omega_inv (H, W, 3), all float32 and
    contiguous on one device -> (num, den), each (sH, sW, 3), or
    (s, s, 3, H, W) with ``phase_output``; ``order=1`` (with
    ``phase_output``) -> the plugin solve's moments (m00, m01, m02, b0),
    or with ``moment_slots=9`` the exact solve's nine (see
    fast_merge.merge_burst_fast). Taps are those of
    fast_merge._active_taps at ``prune_exp``; the defaults are
    merge_fast_pallas's. ``bf16`` (order 0; order 1 ignores it):
    bfloat16 products and per-frame sums (the kernel's form 4, the phase
    layout only). The interleaved form (``phase_output=False``, order 0:
    merge_fast_pallas) refuses a tap radius past 8, as merge_fast_pallas
    does. On CUDA the outputs are views of one allocation."""
    if warped.ndim != 4:
        raise ValueError(f"warped must be (F, H, W, 3), got {tuple(warped.shape)}")
    f, h, w = warped.shape[:3]
    dev = warped.device
    check_tensor("warped", warped, (f, h, w, 3), dev)
    check_tensor("residual", residual, (f, h, w, 2), dev)
    check_tensor("certainty", certainty, (f, h, w, 3), dev)
    check_tensor("omega_inv", omega_inv, (h, w, 3), dev)
    if scale < 1:
        raise ValueError(f"the merge takes scale >= 1, got {scale}")
    if order not in (0, 1):
        raise ValueError(f"the merge takes order 0 or 1, got {order}")
    if order == 1 and not phase_output:
        raise ValueError("the order-1 merge writes the phase layout: pass phase_output=True")
    if order == 1 and moment_slots not in (4, 9):
        raise ValueError(f"the order-1 merge returns 4 or 9 moment slots, got {moment_slots}")
    r_taps = radius + math.ceil(residual_bound)
    if r_taps > _PALLAS_RADIUS and order == 0 and not phase_output:
        raise ValueError(
            f"tap radius {r_taps} exceeds merge_fast_pallas's {_PALLAS_RADIUS}-row halo "
            "(pallas_ops/merge.py:154, the JAX package's own limit of use_pallas)"
        )
    bf16 = bf16 and order == 0
    if bf16 and not phase_output:
        raise ValueError("the bf16 merge form writes the phase layout: pass phase_output=True")

    if dev.type == "cpu":
        return merge_burst_fast(
            warped, residual, certainty, omega_inv, scale, radius,
            residual_bound, k_max, phase_output, order, prune_exp, moment_slots, bf16,
        )

    # cached per key: with the list rebuilt in numpy per call, a call took
    # 0.12-0.26 ms against the first kernel's 0.095 ms of device time
    # (NVIDIA H100 80GB HBM3, 700.00 W)
    key = (r_taps, float(residual_bound), scale, float(k_max), float(prune_exp))
    taps_ptr, n_taps = _tap_args(*key)
    halo = _tap_reach(*key)
    if order == 1:
        form, n_out = (2, 4) if moment_slots == 4 else (3, 9)
    else:
        form, n_out = (4 if bf16 else int(phase_output)), 2
    shape = (scale, scale, 3, h, w) if phase_output else (h * scale, w * scale, 3)
    out = torch.empty((n_out,) + shape, dtype=torch.float32, device=dev)
    args = (warped.data_ptr(), residual.data_ptr(), certainty.data_ptr(),
            omega_inv.data_ptr(), out.data_ptr(), f, h, w, scale, form)
    if uses_general(scale, halo):
        tile = general_tile(scale, halo, form)
        if tile is None:
            # the tap list on the card, made once per (taps, device)
            taps = _const_array(_tap_copy, key, dev)
            launch(library(), "mfsr_merge_fast_unstaged", dev, *args, taps.data_ptr(), n_taps,
                   float(residual_bound))
            LAUNCHES[UNSTAGED] += 1
            return tuple(out.unbind(0))
        tw, th, rows, _, smem = tile
        launch(library(), "mfsr_merge_fast_general", dev, *args, taps_ptr, n_taps, float(residual_bound),
               tw, th, rows, smem)
        LAUNCHES[GENERAL] += 1
        return tuple(out.unbind(0))
    launch(library(), "mfsr_merge_fast", dev, *args, taps_ptr, n_taps, float(residual_bound))
    LAUNCHES[NAME] += 1
    return tuple(out.unbind(0))
