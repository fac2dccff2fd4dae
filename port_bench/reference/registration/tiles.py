"""Tile SSD-surface alignment primitives (counterparts of
registration/tiles.py), batched over a leading frame axis."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from port_bench.reference.ops.filters import _pad_edge
from port_bench.reference.ops.warp_fast import tile_warp_int, tile_warp_select
from port_bench.reference.registration.subpixel import (
    quadratic_subpixel_min,
)


def tile_counts(h: int, w: int, tile_size: int) -> Tuple[int, int]:
    return -(-h // tile_size), -(-w // tile_size)


def _tile_sums(x: torch.Tensor, t: int) -> torch.Tensor:
    """(..., nty*t, ntx*t) -> per-tile sums (..., nty, ntx)."""
    h, w = x.shape[-2], x.shape[-1]
    return x.reshape(x.shape[:-2] + (h // t, t, w // t, t)).sum(dim=(-3, -1))


def extract_ref_tiles(img: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(H, W) -> (nty, ntx, T, T); partial border tiles are edge-padded."""
    h, w = img.shape
    t = tile_size
    nty, ntx = tile_counts(h, w, t)
    img = _pad_edge(_pad_edge(img, 0, 0, nty * t - h), 1, 0, ntx * t - w)
    return img.reshape(nty, t, ntx, t).permute(0, 2, 1, 3)


def extract_search_windows_batched(
    imgs: torch.Tensor, tile_size: int, radius: int, int_shifts: torch.Tensor
) -> torch.Tensor:
    """Per-tile (T+2R)^2 search windows at the integer pre-shift, clamped
    per pixel (convertToTilesOverlapPreShift): the window step of
    tile_search's "tile" mode.

    imgs (N, H, W); int_shifts (N, nty, ntx, 2) over the ceil-divided
    tile grid. Returns (N, nty, ntx, T+2R, T+2R) with
    out[n, ty, tx, u, v] = img[n, clip(ty*T + sy + u - R, 0, H-1),
    clip(tx*T + sx + v - R, 0, W-1)]."""
    n, h, w = imgs.shape
    t = tile_size
    nty, ntx = tile_counts(h, w, t)
    t2 = t + 2 * radius
    dev = imgs.device
    ints = int_shifts.long()
    offs = torch.arange(t2, device=dev) - radius
    oy = (torch.arange(nty, device=dev) * t)[:, None] + ints[..., 0]  # (N, nty, ntx)
    ox = (torch.arange(ntx, device=dev) * t)[None, :] + ints[..., 1]
    yy = (oy[..., None, None] + offs[:, None]).clamp_(0, h - 1)  # (N, nty, ntx, T2, 1)
    xx = (ox[..., None, None] + offs[None, :]).clamp_(0, w - 1)  # (N, nty, ntx, 1, T2)
    flat = (yy * w + xx).reshape(n, -1)
    return torch.gather(imgs.reshape(n, h * w), 1, flat).reshape(n, nty, ntx, t2, t2)


def extract_search_windows(
    img: torch.Tensor, tile_size: int, radius: int, pre_shift: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-tile (T+2R)^2 search windows of one image (H, W) at the rounded
    (half to even) float pre-shift (nty, ntx, 2), zero where None, clamped
    per pixel (registration/tiles.py::extract_search_windows). Returns
    (nty, ntx, T+2R, T+2R)."""
    if img.ndim != 2:
        raise ValueError(
            f"extract_search_windows takes one (H, W) image, as the JAX function does, got shape "
            f"{tuple(img.shape)}; use extract_search_windows_batched for (N, H, W)"
        )
    nty, ntx = tile_counts(img.shape[0], img.shape[1], tile_size)
    if pre_shift is None:
        ints = torch.zeros((nty, ntx, 2), dtype=torch.int32, device=img.device)
    else:
        ints = torch.round(torch.as_tensor(pre_shift, device=img.device)).to(torch.int32)
    return extract_search_windows_batched(img[None], tile_size, radius, ints[None])[0]


def extract_search_windows_fast(
    img: torch.Tensor, tile_size: int, radius: int, pre_shift_int: torch.Tensor | None = None
) -> torch.Tensor:
    """Search windows (nty, ntx, T+2R, T+2R) of one image (H, W) cut from
    the image tile-warped by the integer pre-shifts (``tile_warp_int``),
    so each window's halo follows the neighbouring tiles' own shifts
    (registration/tiles.py::extract_search_windows_fast): window (ty, tx)
    is rows ty*T - R .. ty*T + T + R - 1 (and the columns alike) of the
    warped image, edge-clamped. Needs 2R <= T."""
    h, w = img.shape
    t, r = tile_size, radius
    if 2 * r > t:
        raise ValueError("fast extraction needs search_radius <= tile_size/2")
    nty, ntx = tile_counts(h, w, t)
    b = t + 2 * r
    warped = img if pre_shift_int is None else tile_warp_int(img, pre_shift_int, t)
    p = _pad_edge(_pad_edge(warped, 0, r, (nty + 1) * t - h + r), 1, r, (ntx + 1) * t - w + r)
    return p.unfold(0, b, t).unfold(1, b, t)[:nty, :ntx]


def _window_energies(windows: torch.Tensor, t: int) -> torch.Tensor:
    """Sliding T x T energy sums of (..., T+2R, T+2R) windows through f32
    integral images, in the JAX function's order. Returns
    (..., 2R+1, 2R+1)."""
    sq = windows * windows
    ii = torch.nn.functional.pad(sq, (1, 0, 1, 0)).cumsum(-2).cumsum(-1)
    return ii[..., t:, t:] - ii[..., :-t, t:] - ii[..., t:, :-t] + ii[..., :-t, :-t]


def ssd_surface(ref_tiles: torch.Tensor, windows: torch.Tensor, radius: int) -> torch.Tensor:
    """SSD over all (2R+1)^2 integer shifts of every tile.

    ref_tiles (nty, ntx, T, T); windows (..., nty, ntx, T+2R, T+2R).
    Returns (..., nty, ntx, 2R+1, 2R+1), entry (u, v) the SSD of the tile
    against the window patch at offset (u - R, v - R), in the expanded
    form tsq + wsq - 2 cc of the JAX function."""
    nty, ntx, t, _ = ref_tiles.shape
    s = 2 * radius + 1
    tsq = (ref_tiles * ref_tiles).sum(dim=(-2, -1))
    wsq = _window_energies(windows, t)
    patches = windows.unfold(-2, t, 1).unfold(-2, t, 1)  # (..., nty, ntx, S, S, T, T)
    lead = windows.shape[:-4]
    patches = patches.reshape(lead + (nty, ntx, s * s, t * t))
    cc = (patches @ ref_tiles.reshape(nty, ntx, t * t, 1)).reshape(lead + (nty, ntx, s, s))
    return tsq[..., None, None] + wsq - 2.0 * cc


def ssd_surface_fft(ref_tiles: torch.Tensor, windows: torch.Tensor, radius: int) -> torch.Tensor:
    """ssd_surface with the cross term by per-tile FFT cross-correlation
    (tiles.py:176-199): the first (2R+1)^2 lags of the circular
    correlation of the zero-padded tile with its window, which are linear
    (T + 2R <= T2, no wraparound). torch.fft runs on cuFFT on the card."""
    t = ref_tiles.shape[-1]
    t2 = windows.shape[-1]
    s = 2 * radius + 1
    tsq = (ref_tiles * ref_tiles).sum(dim=(-2, -1))
    wsq = _window_energies(windows, t)
    fr = torch.fft.rfft2(ref_tiles, s=(t2, t2))
    fw = torch.fft.rfft2(windows)
    cc = torch.fft.irfft2(torch.conj(fr) * fw, s=(t2, t2))[..., :s, :s]
    return tsq[..., None, None] + wsq - 2.0 * cc


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

    if subpixel and s >= 3:  # below, every minimum lies on the border
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
    """One pyramid level of the tile search: the plain version of the tile
    search kernel (kernels/tile_search.py).

    ref (H, W); alts (N, H, W); rounded (N, nty, ntx, 2), the rounded
    prediction over the ceil-divided tile grid. Returns rounded +
    find_min_shift(SSD) (N, nty, ntx, 2), the SSD surfaces taken over
    ``mode``'s windows:

    - "image" (align_frames' fast branch): the alternates tile-warped by
      the prediction (tile_warp_select, bound 16), halos crossing tile
      borders (ssd_surface_image);
    - "tile" (the windows branch): per-tile windows at the prediction,
      clamped per pixel (extract_search_windows, ssd_surface)."""
    if mode == "image":
        warped = tile_warp_select(alts, rounded.to(torch.int32), tile_size)
        ssd = ssd_surface_image(ref, warped, tile_size, radius)
    elif mode == "tile":
        windows = extract_search_windows_batched(alts, tile_size, radius, rounded.to(torch.int32))
        ssd = ssd_surface(extract_ref_tiles(ref, tile_size), windows, radius)
    else:
        raise ValueError(f"mode must be 'image' or 'tile', got {mode!r}")
    return rounded + find_min_shift(ssd, radius, threshold, subpixel)


_F32_UNIT = 2.0**-24  # float32's unit roundoff
ILL_CONDITIONED_PX = 0.1
# the FFT cross term's error in units of u log2(n) |f|_2 |w|_2: one unit a
# transform for the three of an FFT correlation, and as much again for the
# twiddle factors' own rounding
FFT_ERROR_C = 6.0


def _exact_windows(ref, alts, rounded, t, radius, mode):
    """tile_search's reference tiles (nty, ntx, T, T) and search windows
    (N, nty, ntx, T+2R, T+2R) in float64, values as the search reads them."""
    n, h, w = alts.shape
    nty, ntx = tile_counts(h, w, t)
    ints = rounded.to(torch.int32)
    if mode == "image":
        warped = tile_warp_select(alts.double(), ints, t)
        warped = _pad_edge(_pad_edge(warped, -2, 0, nty * t - h), -1, 0, ntx * t - w)
        padded = _pad_edge(_pad_edge(warped, -2, radius, radius), -1, radius, radius)
        t2 = t + 2 * radius
        windows = padded.unfold(-2, t2, t).unfold(-2, t2, t)
    else:
        windows = extract_search_windows_batched(alts.double(), t, radius, ints)
    return extract_ref_tiles(ref.double(), t), windows


def float32_undecided(
    ref: torch.Tensor,
    alts: torch.Tensor,
    rounded: torch.Tensor,
    tile_size: int,
    radius: int,
    threshold: float = 0.0,
    mode: str = "image",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tiles on which tile_search's result is set by float32 rounding,
    the yardstick two float32 searches (the kernel and this plain version,
    or the JAX function) are held to. Returns two (N, nty, ntx) bool masks:

    - ``argmin``: the SSD surface's minimum, or the threshold gate, is
      within rounding. Each entry of the expanded form tsq + wsq - 2 cc,
      summed in float32 in any order, lies within (T^2 + 2) u (tsq + wsq
      + 2 sum|w f|) of its exact value (u = 2^-24: T^2 terms a sum, two
      more additions); two offsets whose exact values lie within the sum
      of their bounds are ranked by rounding. Windows whose rows or
      columns repeat each other, as where pre-alignment clamps a rotated
      frame to its edge, make such surfaces: flat along one axis.
    - ``fit``: the 3x3 subpixel fit around the exact minimum is
      ill-conditioned: its float64 shift moves by more than
      ILL_CONDITIONED_PX when each of its nine values moves within its
      bound (first order, one value at a time, summed), a near-singular
      curvature.

    Surfaces and fits in float64 from direct sums, on the inputs' device."""
    argmin, moved = _rounding_margins(ref, alts, rounded, tile_size, radius, threshold, mode, fft=False)
    return argmin, moved > ILL_CONDITIONED_PX


def fft_undecided(
    ref: torch.Tensor,
    alts: torch.Tensor,
    rounded: torch.Tensor,
    tile_size: int,
    radius: int,
    threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32_undecided for align_frames' FFT branch (windows at the
    rounded prediction, ssd_surface_fft), whose surface entries carry two
    more errors: the window energy, a difference of four entries of a
    float32 integral image (two prefix sums of at most T2 = T + 2R terms
    each), lies within 8 T2 u sum w^2 of its exact value; the cross term,
    from three float32 transforms of size T2^2, within FFT_ERROR_C u
    log2(T2^2) |f|_2 |w|_2 (the norm-wise error of an FFT convolution,
    which bounds each entry). Returns the (N, nty, ntx) ``argmin`` mask
    and, in place of the ``fit`` mask, the fit's movement (px) under
    those bounds: the distance two float32 FFT searches may put between
    their subpixel shifts on a tile whose argmin they share."""
    return _rounding_margins(ref, alts, rounded, tile_size, radius, threshold, "tile", fft=True)


def _rounding_margins(ref, alts, rounded, t, radius, threshold, mode, fft):
    """(argmin mask, fit movement in px) of float32_undecided and
    fft_undecided."""
    s = 2 * radius + 1
    tiles_f, windows = _exact_windows(ref, alts, rounded, t, radius, mode)
    tsq = (tiles_f * tiles_f).sum((-2, -1))[..., None]  # (nty, ntx, 1)
    ssd, mag = [], []
    for u in range(s):  # one row of offsets at a time: (N, nty, ntx, S, T, T)
        patches = windows[..., u : u + t, :].unfold(-1, t, 1).permute(0, 1, 2, 4, 3, 5)
        ssd.append(((patches - tiles_f[:, :, None]) ** 2).sum((-2, -1)))
        mag.append(tsq + (patches * patches).sum((-2, -1))
                   + 2.0 * (patches * tiles_f[:, :, None]).abs().sum((-2, -1)))
    ssd = torch.stack(ssd, -2).flatten(-2)  # (N, nty, ntx, S*S)
    bound = (t * t + 2) * _F32_UNIT * torch.stack(mag, -2).flatten(-2)
    if fft:
        t2 = windows.shape[-1]
        w_sq = (windows * windows).sum((-2, -1))[..., None]  # (N, nty, ntx, 1)
        cross = FFT_ERROR_C * math.log2(t2 * t2) * (tsq * w_sq).sqrt()
        bound = bound + _F32_UNIT * (8 * t2 * w_sq + 2.0 * cross)

    i_min = ssd.argmin(-1, keepdim=True)
    i_max = ssd.argmax(-1, keepdim=True)
    lo, b_lo = ssd.gather(-1, i_min), bound.gather(-1, i_min)
    hi, b_hi = ssd.gather(-1, i_max), bound.gather(-1, i_max)
    near = (ssd - lo <= b_lo + bound).sum(-1) > 1
    gate = ((lo + threshold - hi).abs() <= b_lo + b_hi).squeeze(-1)

    py, px = (i_min.squeeze(-1) // s).clamp(1, s - 2), (i_min.squeeze(-1) % s).clamp(1, s - 2)
    k = torch.arange(-1, 2, device=ssd.device)
    at = ((py[..., None] + k)[..., :, None] * s + (px[..., None] + k)[..., None, :]).flatten(-2)
    patch, b_patch = ssd.gather(-1, at), bound.gather(-1, at)  # (..., 9)
    mu = quadratic_subpixel_min(patch.unflatten(-1, (3, 3)))
    moved = torch.zeros_like(mu)
    for j in range(9):
        step = torch.zeros(9, dtype=ssd.dtype, device=ssd.device)
        step[j] = 1.0
        moved = moved + torch.maximum(
            *((quadratic_subpixel_min((patch + sign * b_patch * step).unflatten(-1, (3, 3))) - mu).abs()
              for sign in (1.0, -1.0))
        )
    return near | gate, moved.amax(-1)


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
