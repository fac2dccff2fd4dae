"""Wrapper of the Hopper RAW merge kernel (csrc/merge_raw.cu): the
plane-domain order-1 merge of the RAW path, certless plugin branch, at
scales 1-4. The JAX package computes it outside Pallas
(models/fast_merge.py::merge_burst_raw_planes); it has the skeleton of
pallas_ops/merge.py::merge_fast_pallas.

On CUDA tensors it launches the kernel or raises; it never falls back.
On CPU tensors it computes the plain PyTorch version,
models/fast_merge.py::merge_burst_raw_planes, with the same taps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

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
    merge_burst_raw_planes,
)

NAME = "merge_raw"
SOURCE = "merge_raw.cu"
_MAX_TAPS = 81  # kMaxTaps in csrc/merge_raw.cu
_SCALES = (1, 2, 3, 4)  # the kernel's instantiations (Layout<S> in csrc/merge_raw.cu)


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = bind(
        load_library(SOURCE), "mfsr_merge_raw",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int],
    )
    lib.mfsr_merge_raw_max_frames.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mfsr_merge_raw_max_frames.restype = ctypes.c_int
    return lib


def tap_halo(taps) -> int:
    """The most half-res sites a tap reaches from its pixel, (a + k) // 2
    over both parities a (at least 1): the kernel's staged halo."""
    return max([1] + [abs((a + k) // 2) for t in taps for k in t for a in (0, 1)])


def is_bayer(cfa) -> bool:
    """Green on one diagonal of the 2 x 2 pattern, R and B on the other:
    the patterns the kernel takes."""
    q = [int(cfa[0][0]), int(cfa[0][1]), int(cfa[1][0]), int(cfa[1][1])]
    return sorted(q) == [0, 1, 1, 2] and (q[0] == q[3] == 1 or q[1] == q[2] == 1)


@functools.lru_cache(maxsize=None)
def tap_table(taps: tuple, cfa: tuple) -> np.ndarray:
    """The kernel's host table (int32): the channel of each plane
    q = 2*qa + qb (4 values); the end of each tap-parity group
    g = 2*(ky%2) + (kx%2) (4); then the taps as (ky, kx) rows, sorted by
    group and in list order within it. Within a group a parity always
    reads the same plane, and the taps feed the same two certless chains
    (fast_merge._centroid_chain)."""
    chan = [int(cfa[q // 2][q % 2]) for q in range(4)]
    groups = [[t for t in taps if 2 * (t[0] % 2) + t[1] % 2 == g] for g in range(4)]
    ends = np.cumsum([len(grp) for grp in groups]).tolist()
    rows = [k for grp in groups for t in grp for k in t]
    table = np.asarray(chan + ends + rows, np.int32)
    table.flags.writeable = False  # cached and shared by every call
    return table


def merge_raw(
    planes: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    omega_inv_rb: torch.Tensor,
    cfa,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
    prune_exp: float = 6.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """RAW order-1 certless merge: planes (F, 2, 2, hh, hw), residual
    (F, hh, hw, 2) in RAW units, certainty (F, hh, hw, 3), omega_inv and
    omega_inv_rb (hh, hw, 3), all float32 and contiguous on one device ->
    (m00, cy, cx, b0), each (2s, 2s, 3, hh, hw) (see
    fast_merge.merge_burst_raw_planes). The kernel takes scales 1-4, Bayer
    patterns and up to mfsr_merge_raw_max_frames frames; on CUDA tensors
    anything else raises ValueError."""
    if planes.ndim != 5:
        raise ValueError(f"planes must be (F, 2, 2, hh, hw), got {tuple(planes.shape)}")
    f, hh, hw = planes.shape[0], planes.shape[3], planes.shape[4]
    dev = planes.device
    check_tensor("planes", planes, (f, 2, 2, hh, hw), dev)
    check_tensor("residual", residual, (f, hh, hw, 2), dev)
    check_tensor("certainty", certainty, (f, hh, hw, 3), dev)
    check_tensor("omega_inv", omega_inv, (hh, hw, 3), dev)
    check_tensor("omega_inv_rb", omega_inv_rb, (hh, hw, 3), dev)
    if dev.type == "cpu":
        return merge_burst_raw_planes(
            planes, residual, certainty, omega_inv, omega_inv_rb, cfa, scale,
            radius, residual_bound, k_max, prune_exp,
        )
    r_taps = radius + int(np.ceil(residual_bound))
    taps = _active_taps(r_taps, residual_bound, scale, k_max, prune_exp)
    if scale not in _SCALES:
        raise ValueError(f"the RAW merge kernel takes scales 1..4, got scale {scale}")
    if not is_bayer(cfa):
        raise ValueError(f"the RAW merge kernel takes Bayer patterns, got {cfa}")
    if len(taps) > _MAX_TAPS:
        raise ValueError(f"{len(taps)} taps exceed the kernel's {_MAX_TAPS}")
    lib = library()
    max_frames = lib.mfsr_merge_raw_max_frames(scale, tap_halo(taps))
    if f > max_frames:
        raise ValueError(f"{f} frames exceed the {max_frames} whose tiles fit a block's shared memory")

    # built once per (taps, pattern): rebuilt per call it held a call to
    # 0.66 ms against the first kernel's 0.18 ms (NVIDIA H100 80GB HBM3,
    # 700.00 W)
    table = tap_table(tuple(taps), tuple(tuple(int(c) for c in row) for row in cfa))
    outs = [
        torch.empty((2 * scale, 2 * scale, 3, hh, hw), dtype=torch.float32, device=dev)
        for _ in range(4)
    ]
    launch(
        lib, "mfsr_merge_raw", dev,
        planes.data_ptr(), residual.data_ptr(), certainty.data_ptr(),
        omega_inv.data_ptr(), omega_inv_rb.data_ptr(),
        *(o.data_ptr() for o in outs),
        f, hh, hw, scale, float(residual_bound), table.ctypes.data, len(taps),
    )
    LAUNCHES[NAME] += 1
    return tuple(outs)
