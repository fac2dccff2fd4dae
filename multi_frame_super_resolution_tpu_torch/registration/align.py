"""Coarse-to-fine tile-pyramid burst alignment (counterpart of
registration/align.py), the fused fast branch of ``align_frames``:
tile-warp each alternate by the rounded prediction, build every tile's
SSD surface, take the subpixel argmin."""

from __future__ import annotations

from typing import List

import torch

from multi_frame_super_resolution_tpu_torch.config import AlignConfig
from multi_frame_super_resolution_tpu_torch.ops.geometry import downsample2, resize
from multi_frame_super_resolution_tpu_torch.ops.warp_fast import (
    tile_warp_select,
    upsample_int,
)
from multi_frame_super_resolution_tpu_torch.registration.tiles import (
    find_min_shift,
    ssd_surface_image,
    tile_counts,
    upsample_shift_field,
)


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[finest, ..., coarsest] 2x-decimated pyramid of (..., H, W)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def align_frames(
    ref: torch.Tensor, alts: torch.Tensor, cfg: AlignConfig = AlignConfig()
) -> torch.Tensor:
    """Per-tile shift fields (F, nty, ntx, 2) at the finest level such that
    alt_f(tile_pos + shift_f) ~= ref(tile_pos). ref (H, W); alts (F, H, W)."""
    if cfg.use_fft or not cfg.fast_extract:
        raise ValueError("the port implements only the fast_extract, non-FFT branch")
    f = alts.shape[0]
    ref_pyr = build_pyramid(ref, cfg.levels)
    alt_pyr = build_pyramid(alts, cfg.levels)

    total = None
    for level in range(cfg.levels - 1, -1, -1):
        radius = (
            cfg.fine_radius
            if (level == 0 and cfg.fine_radius is not None)
            else cfg.search_radius
        )
        if 2 * radius > cfg.tile_size:
            raise ValueError("the fast branch needs search radius <= tile_size/2")
        r = ref_pyr[level]
        a = alt_pyr[level]
        nty, ntx = tile_counts(r.shape[0], r.shape[1], cfg.tile_size)
        if total is None:
            total = torch.zeros((f, nty, ntx, 2), dtype=torch.float32, device=ref.device)
        else:
            total = upsample_shift_field(total, nty, ntx, float(cfg.downsample))
        # windows are offset by the ROUNDED prediction, so the search
        # finds the residual relative to it
        rounded = torch.round(total)
        warped = tile_warp_select(a, rounded.to(torch.int32), cfg.tile_size)
        ssd = ssd_surface_image(r, warped, cfg.tile_size, radius)
        found = find_min_shift(ssd, radius, cfg.peak_threshold, cfg.subpixel)
        total = rounded + found
    return total


def align_burst(
    burst: torch.Tensor, cfg: AlignConfig = AlignConfig(), ref_index: int = 0
) -> torch.Tensor:
    """Align every frame of a grayscale burst (F, H, W) against the
    reference frame: (F, nty, ntx, 2), zero for the reference."""
    alts = torch.cat([burst[:ref_index], burst[ref_index + 1 :]], dim=0)
    shifts = align_frames(burst[ref_index], alts, cfg)
    zero = torch.zeros_like(shifts[:1])
    return torch.cat([shifts[:ref_index], zero, shifts[ref_index:]], dim=0)


def flow_from_tile_shifts(
    shifts: torch.Tensor, tile_size: int, height: int, width: int
) -> torch.Tensor:
    """Per-tile shift fields (..., nty, ntx, 2) -> dense flows
    (..., H, W, 2), bilinearly interpolated (the smooth form). Exact tile
    multiples take the polyphase upsample, others the resize, as the JAX
    function does."""
    nty, ntx = shifts.shape[-3], shifts.shape[-2]
    if height == nty * tile_size and width == ntx * tile_size:
        return upsample_int(shifts, tile_size, "bilinear")
    return resize(shifts, height, width)
