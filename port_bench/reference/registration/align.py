"""Coarse-to-fine tile-pyramid burst alignment (counterpart of
registration/align.py), the three branches of ``align_frames``: the fast
branch (SSD surfaces over the alternates tile-warped by the rounded
prediction) and the windows branch (per-tile search windows at the
rounded prediction), each one call of the tile search kernel per level
on CUDA (kernels/tile_search.py), and the FFT branch (align.use_fft: the
windows branch's windows, the cross term by cuFFT), each followed by the
subpixel argmin; and the shift-consistent burst alignment
(``align_burst_consistent``, registration/global_shift.py)."""

from __future__ import annotations

from typing import List

import torch

from port_bench.reference.config import AlignConfig
from port_bench.reference.registration.tiles import tile_search
from port_bench.reference.ops.geometry import downsample2_planes, resize
from port_bench.reference.ops.warp_fast import upsample_int
from port_bench.reference.registration.global_shift import (
    measurement_pairs,
    shifts_to_reference,
    solve_consistent_shifts,
)
from port_bench.reference.registration.tiles import (
    extract_ref_tiles,
    extract_search_windows_batched,
    find_min_shift,
    ssd_surface_fft,
    tile_counts,
    upsample_shift_field,
)


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[finest, ..., coarsest] 2x-decimated pyramid of (..., H, W)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2_planes(pyr[-1]))
    return pyr


def align_frames(
    ref: torch.Tensor, alts: torch.Tensor, cfg: AlignConfig = AlignConfig()
) -> torch.Tensor:
    """Per-tile shift fields (F, nty, ntx, 2) at the finest level such that
    alt_f(tile_pos + shift_f) ~= ref(tile_pos). ref (H, W); alts (F, H, W).
    Under ``cfg.use_fft`` the tile search does not run: the JAX function
    there is the windows branch's surface with the FFT cross term."""
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
        if cfg.use_fft:
            windows = extract_search_windows_batched(a, cfg.tile_size, radius, rounded.to(torch.int32))
            ssd = ssd_surface_fft(extract_ref_tiles(r, cfg.tile_size), windows, radius)
            total = rounded + find_min_shift(ssd, radius, cfg.peak_threshold, cfg.subpixel)
            continue
        mode = "image" if cfg.fast_extract and 2 * radius <= cfg.tile_size else "tile"
        total = tile_search(
            r.contiguous(), a.contiguous(), rounded, cfg.tile_size, radius,
            cfg.peak_threshold, cfg.subpixel, mode,
        )
    return total


def align_pair(ref: torch.Tensor, alt: torch.Tensor, cfg: AlignConfig = AlignConfig()) -> torch.Tensor:
    """One pair: (nty, ntx, 2) with alt(tile_pos + shift) ~= ref(tile_pos)."""
    return align_frames(ref, alt[None], cfg)[0]


def align_burst(
    burst: torch.Tensor, cfg: AlignConfig = AlignConfig(), ref_index: int = 0
) -> torch.Tensor:
    """Align every frame of a grayscale burst (F, H, W) against the
    reference frame: (F, nty, ntx, 2), zero for the reference."""
    alts = torch.cat([burst[:ref_index], burst[ref_index + 1 :]], dim=0)
    shifts = align_frames(burst[ref_index], alts, cfg)
    zero = torch.zeros_like(shifts[:1])
    return torch.cat([shifts[:ref_index], zero, shifts[ref_index:]], dim=0)


def align_burst_consistent(
    burst: torch.Tensor, cfg: AlignConfig = AlignConfig(), ref_index: int = 0, max_span: int = 2
) -> torch.Tensor:
    """Burst alignment through the shift-consistency solve (align.py:157-180):
    the pairs of measurement_pairs(F, max_span) aligned, the per-tile
    chain solved with outlier rejection, the optimal shifts accumulated to
    the reference frame: (F, nty, ntx, 2). Pairs that share their first
    frame are aligned in one align_frames call, as that frame's
    alternates (the same function: each alternate is searched alone), so
    the tile search launches once per first frame and pyramid level."""
    f = burst.shape[0]
    pairs = measurement_pairs(f, max_span)
    measured = {}
    for i in sorted({i for i, _ in pairs}):
        js = [j for i2, j in pairs if i2 == i]
        for j, shift in zip(js, align_frames(burst[i], burst[js], cfg)):
            measured[(i, j)] = shift
    consecutive, _ = solve_consistent_shifts(torch.stack([measured[p] for p in pairs]), f, tuple(pairs))
    return shifts_to_reference(consecutive, ref_index)


def flow_from_tile_shifts(
    shifts: torch.Tensor, tile_size: int, height: int, width: int, smooth: bool = True
) -> torch.Tensor:
    """Per-tile shift fields (nty, ntx, 2), or a batch (..., nty, ntx, 2),
    -> dense flows (..., H, W, 2): bilinearly interpolated when ``smooth``
    (exact tile multiples take the polyphase upsample, others the
    resize, as the JAX function does), else piecewise constant (the
    nearest-neighbour resize)."""
    nty, ntx = shifts.shape[-3], shifts.shape[-2]
    if smooth and height == nty * tile_size and width == ntx * tile_size:
        return upsample_int(shifts, tile_size, "bilinear")
    return resize(shifts, height, width, "bilinear" if smooth else "nearest")
