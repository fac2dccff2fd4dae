"""The plain versions of the program's four kernels, with the signatures
the pipelines call them by: the merges (RGB and RAW), the tile warp. The
tile search's plain version is ``registration.tiles.tile_search``.

Each is what the program's wrapper in ``kernels/`` runs on CPU tensors,
frozen here and run on whatever device its inputs are on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from port_bench.reference.models.fast_merge import (
    NINE_MOMENTS,
    ORDER0,
    PER_CELL,
    guided_planes,
    merge_burst_fast,
    merge_burst_raw_planes,
    raw_merge_form,
)
from port_bench.reference.ops import warp_fast


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
    """The RGB static-tap merge (fast_merge.merge_burst_fast)."""
    bf16 = bf16 and order == 0
    return merge_burst_fast(
        warped, residual, certainty, omega_inv, scale, radius, residual_bound, k_max,
        phase_output=phase_output, bf16=bf16, order=order, prune_exp=prune_exp, moment_slots=moment_slots,
    )


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
    order: int = 1,
    moment_slots: int = 4,
    guide: Optional[torch.Tensor] = None,
    centroid_cert: bool = False,
    exact_weights: bool = False,
    centroid_prune: Optional[float] = None,
    centroid_bf16: bool = False,
    centroid_block: bool = False,
    centroid_shared_res: bool = False,
    bf16: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The RAW plane merge in the phase layout
    (fast_merge.merge_burst_raw_planes), each knob read only by the form
    that reads it."""
    form = raw_merge_form(order, moment_slots, centroid_cert, exact_weights)
    bf16 = bf16 and form == ORDER0
    exact_weights = exact_weights and form in (NINE_MOMENTS, PER_CELL)
    per_cell = form == PER_CELL
    shared = per_cell and centroid_shared_res
    block = per_cell and (centroid_block or shared)
    centroid_bf16 = per_cell and centroid_bf16 and not block
    centroid_prune = centroid_prune if per_cell else None
    if guide is not None:
        planes = guided_planes(planes, guide, cfa, bf16)
    return merge_burst_raw_planes(
        planes, residual, certainty, omega_inv, omega_inv_rb, cfa, scale, radius, residual_bound, k_max,
        phase_output=True, bf16=bf16, order=order, prune_exp=prune_exp, moment_slots=moment_slots,
        exact_weights=exact_weights, centroid_prune=centroid_prune, centroid_bf16=centroid_bf16,
        centroid_block=block, centroid_shared_res=shared, centroid_cert=centroid_cert,
    )


def tile_warp(
    imgs: torch.Tensor, int_shifts: torch.Tensor, tile_size: int, bound: int = 16, onehot: bool = False
) -> torch.Tensor:
    """Per-tile integer warp of planes (B, N, H, W) by int_shifts
    (B, nty, ntx, 2): the selector-matmul function, or with ``onehot`` the
    one-hot select's."""
    if onehot:
        return warp_fast.tile_warp_select(imgs, int_shifts[:, None], tile_size, bound)
    return warp_fast.tile_warp_matmul(imgs, int_shifts, tile_size, bound)
