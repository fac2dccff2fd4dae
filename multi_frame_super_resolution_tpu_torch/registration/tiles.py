"""Tile SSD-surface alignment primitives (counterparts of
registration/tiles.py), batched over a leading frame axis."""

from __future__ import annotations

from typing import Tuple

import torch

from multi_frame_super_resolution_tpu_torch.ops.filters import _pad_edge
from multi_frame_super_resolution_tpu_torch.registration.subpixel import (
    quadratic_subpixel_min,
)


def tile_counts(h: int, w: int, tile_size: int) -> Tuple[int, int]:
    return -(-h // tile_size), -(-w // tile_size)


def _tile_sums(x: torch.Tensor, t: int) -> torch.Tensor:
    """(..., nty*t, ntx*t) -> per-tile sums (..., nty, ntx)."""
    h, w = x.shape[-2], x.shape[-1]
    return x.reshape(x.shape[:-2] + (h // t, t, w // t, t)).sum(dim=(-3, -1))


def ssd_surface_image(
    ref_img: torch.Tensor,
    warped_img: torch.Tensor,
    tile_size: int,
    radius: int,
) -> torch.Tensor:
    """SSD surfaces of every tile over all (2R+1)^2 integer offsets.

    ref_img (H, W); warped_img (B, H, W), already tile-warped by the
    rounded prediction, so halos cross tile borders (the semantics of
    ssd_surface_image and extract_search_windows_fast). Returns
    (B, nty, ntx, 2R+1, 2R+1), entry (u, v) comparing the tile with the
    warped image at offset (u - R, v - R).

    Kept in the expanded form tsq + wsq - 2 cc of the JAX function
    (tiles.py:302-304): a direct sum of squared differences rounds
    differently and can move the argmin on flat tiles.
    """
    h, w = ref_img.shape
    t = tile_size
    r = radius
    s = 2 * r + 1
    nty, ntx = tile_counts(h, w, t)
    pad_h, pad_w = nty * t - h, ntx * t - w
    ref_img = _pad_edge(_pad_edge(ref_img, 0, 0, pad_h), 1, 0, pad_w)
    warped_img = _pad_edge(_pad_edge(warped_img, -2, 0, pad_h), -1, 0, pad_w)
    h, w = ref_img.shape

    padded = _pad_edge(_pad_edge(warped_img, -2, r, r), -1, r, r)  # (B, H+2R, W+2R)
    # every offset's window as a view: (B, S, S, H, W)
    win = padded.unfold(-2, h, 1).unfold(-2, w, 1)
    tsq = _tile_sums(ref_img * ref_img, t)  # (nty, ntx)
    wsq = _tile_sums(win * win, t)  # (B, S, S, nty, ntx)
    cc = _tile_sums(win * ref_img, t)
    ssd = tsq + wsq - 2.0 * cc
    return ssd.permute(0, 3, 4, 1, 2).reshape(-1, nty, ntx, s, s)


def find_min_shift(
    ssd: torch.Tensor,
    radius: int,
    threshold: float = 0.0,
    subpixel: bool = True,
) -> torch.Tensor:
    """Per-tile subpixel argmin of SSD surfaces (..., S, S) with
    findMinimum's gating: border minima and insignificant peaks
    (min + threshold > max) give zero shift. Returns (..., 2) as (dy, dx).
    torch.argmin and jnp.argmin both return the first minimum."""
    s = ssd.shape[-1]
    flat = ssd.reshape(ssd.shape[:-2] + (s * s,))
    idx = flat.argmin(dim=-1)
    min_val = flat.amin(dim=-1)
    max_val = flat.amax(dim=-1)
    py = idx // s
    px = idx % s

    on_border = (py < 1) | (py >= s - 1) | (px < 1) | (px >= s - 1)
    shift = torch.stack([py.float() - radius, px.float() - radius], dim=-1)

    if subpixel:
        cy = py.clamp(1, s - 2)
        cx = px.clamp(1, s - 2)
        k = torch.arange(-1, 2, device=ssd.device)
        rows = (cy[..., None] + k)[..., :, None]  # (..., 3, 1)
        cols = (cx[..., None] + k)[..., None, :]  # (..., 1, 3)
        patch = torch.gather(flat, -1, (rows * s + cols).flatten(-2)).unflatten(-1, (3, 3))
        shift = shift + quadratic_subpixel_min(patch)

    shift = torch.where(on_border[..., None], 0.0, shift)
    insignificant = (min_val + threshold) > max_val
    return torch.where(insignificant[..., None], 0.0, shift)


def upsample_shift_field(
    shifts: torch.Tensor,
    new_nty: int,
    new_ntx: int,
    value_scale: float,
) -> torch.Tensor:
    """Bilinear upsample of per-tile shift fields (..., nty, ntx, 2) between
    pyramid levels, with the level rescaling of the values."""
    nty, ntx = shifts.shape[-3], shifts.shape[-2]
    dev = shifts.device
    oy = (torch.arange(new_nty, dtype=torch.float32, device=dev) * (nty / new_nty)).clamp(0, nty - 1)
    ox = (torch.arange(new_ntx, dtype=torch.float32, device=dev) * (ntx / new_ntx)).clamp(0, ntx - 1)
    y0 = torch.floor(oy).long()
    x0 = torch.floor(ox).long()
    y1 = (y0 + 1).clamp(max=nty - 1)
    x1 = (x0 + 1).clamp(max=ntx - 1)
    fy = (oy - y0)[:, None, None]
    fx = (ox - x0)[None, :, None]

    def at(yi, xi):
        return shifts.index_select(-3, yi).index_select(-2, xi)

    p00, p01, p10, p11 = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
    top = p00 + (p01 - p00) * fx
    bot = p10 + (p11 - p10) * fx
    return (top + (bot - top) * fy) * value_scale
