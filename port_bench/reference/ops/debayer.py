"""Bayer demosaicing (counterpart of ops/debayer.py): the full-resolution
Wu-Zhang demosaic and the half-resolution quad subsample, both on
(H, W) mosaics with the CFA pattern a 2 x 2 tuple of channel codes
(0 = R, 1 = G, 2 = B).

Every interpolation hypothesis is computed over the whole image from
edge-clamped shifted views and selected with the CFA phase masks, as in
the JAX function; the masks are numpy constants made once per device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from port_bench.reference.ops.filters import _const, _const_array
from port_bench.reference.ops.warp_fast import _pad_last2, _shifted

CFA = Tuple[Tuple[int, int], Tuple[int, int]]

RGGB: CFA = ((0, 1), (1, 2))
BGGR: CFA = ((2, 1), (1, 0))
GRBG: CFA = ((1, 0), (2, 1))
GBRG: CFA = ((1, 2), (0, 1))


def _key(cfa) -> CFA:
    return tuple(tuple(int(c) for c in row) for row in cfa)


def cfa_channel_map(h: int, w: int, cfa: CFA) -> np.ndarray:
    """(H, W) int map of each pixel's CFA channel."""
    pat = np.asarray(cfa, np.int32)
    return np.tile(pat, ((h + 1) // 2, (w + 1) // 2))[:h, :w]


def _site_masks(h: int, w: int, cfa: CFA) -> np.ndarray:
    """(5, H, W) bool: R, G, B sites, then the green sites whose
    horizontal neighbours are red and those whose are blue."""
    ch = cfa_channel_map(h, w, cfa)
    ch_right = cfa_channel_map(h, w + 1, cfa)[:, 1:]
    is_g = ch == 1
    return np.stack([ch == 0, is_g, ch == 2, is_g & (ch_right == 0), is_g & (ch_right == 2)])


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped shifted view: out[y, x] = x[clamp(y + dy), clamp(x + dx)]."""
    pad = max(abs(dy), abs(dx), 1)
    return _shifted(_pad_last2(x, pad, pad), pad, dy, dx, x.shape[-2], x.shape[-1])


def scale_raw(
    raw: torch.Tensor,
    cfa: CFA,
    black_point: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Per-site black-point and scale normalization: every pixel by its
    own channel's black point and scale."""
    h, w = raw.shape
    ch = _const_array(cfa_channel_map, (h, w, _key(cfa)), raw.device).long()
    bp = _const(tuple(float(v) for v in black_point), raw.device)[ch]
    sc = _const(tuple(float(v) for v in scale), raw.device)[ch]
    return (raw.float() - bp) * sc


def debayer(
    raw: torch.Tensor,
    cfa: CFA = RGGB,
    black_point: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Full-resolution demosaic of an (H, W) mosaic -> (H, W, 3) float32:
    gradient- and Laplacian-weighted green interpolation (Wu-Zhang),
    then red and blue by colour difference to green."""
    h, w = raw.shape
    is_r, is_g, is_b, is_g_redrow, is_g_bluerow = _const_array(_site_masks, (h, w, _key(cfa)), raw.device)

    # every neighbour read is normalized by the neighbour site's own
    # channel, which is `same` shifted
    same = scale_raw(raw, cfa, black_point, scale)
    sp = _pad_last2(same, 2, 2)

    def s(dy, dx):
        return _shifted(sp, 2, dy, dx, h, w)

    # green at R/B sites
    p = same
    xm2, xm1 = s(0, -2), s(0, -1)
    xp1, xp2 = s(0, 1), s(0, 2)
    ym2, ym1 = s(-2, 0), s(-1, 0)
    yp1, yp2 = s(1, 0), s(2, 0)

    grad_x = 0.5 * (xp1 - xm1).abs()
    grad_y = 0.5 * (yp1 - ym1).abs()
    lap_x = 0.25 * (2.0 * p - xm2 - xp2).abs()
    lap_y = 0.25 * (2.0 * p - ym2 - yp2).abs()
    interp_x = 0.125 * (-xm2 + 4.0 * xm1 + 2.0 * p + 4.0 * xp1 - xp2)
    interp_y = 0.125 * (-ym2 + 4.0 * ym1 + 2.0 * p + 4.0 * yp1 - yp2)
    weight = (grad_y + lap_y) / (grad_x + grad_y + lap_x + lap_y + 1e-9)
    g_interp = weight * interp_x + (1.0 - weight) * interp_y
    green = torch.where(is_g, same, g_interp)

    # red and blue by colour difference to green
    gp = _pad_last2(green, 1, 1)

    def g(dy, dx):
        return _shifted(gp, 1, dy, dx, h, w)

    horiz = green + 0.5 * ((xm1 - g(0, -1)) + (xp1 - g(0, 1)))
    vert = green + 0.5 * ((ym1 - g(-1, 0)) + (yp1 - g(1, 0)))
    diag = green + 0.25 * (
        (s(-1, -1) - g(-1, -1)) + (s(-1, 1) - g(-1, 1)) + (s(1, 1) - g(1, 1)) + (s(1, -1) - g(1, -1))
    )

    red = torch.where(is_r, same, torch.where(is_g_redrow, horiz, torch.where(is_g_bluerow, vert, diag)))
    blue = torch.where(is_b, same, torch.where(is_g_redrow, vert, torch.where(is_g_bluerow, horiz, diag)))
    return torch.stack([red, green, blue], dim=-1)


def debayer_subsample(raw: torch.Tensor, cfa: CFA = RGGB, max_val: float = 1.0) -> torch.Tensor:
    """Half-resolution RGB from each 2 x 2 Bayer quad of ``raw`` (..., H, W)
    -> (..., H//2, W//2, 3): same-channel sites averaged, values divided
    by ``max_val``."""
    h2, w2 = raw.shape[-2] // 2, raw.shape[-1] // 2
    lead = raw.shape[:-2]
    quads = raw[..., : h2 * 2, : w2 * 2].reshape(lead + (h2, 2, w2, 2)).transpose(-3, -2)
    quads = quads.float() / max_val
    pat = np.asarray(cfa)
    out = []
    for c in range(3):
        sel = pat == c
        wgt = tuple(float(v) for v in (sel.astype(np.float32) / max(sel.sum(), 1)).ravel())
        out.append((quads * _const(wgt, raw.device).reshape(2, 2)).sum((-2, -1)))
    return torch.stack(out, dim=-1)
