"""Warp primitives of the fast path (counterparts of ops/warp_fast.py).

The JAX package builds every warp from static shifts, one-hot selects
and selector matmuls because per-pixel gathers are slow on a TPU. A GPU
reads indexed loads at full rate, so the port computes the same
*functions* as direct index gathers. Where a TPU formulation defines a
function that differs from the naive one (the two-level one-hot warp,
the separable selector warp), the closed form of what it computes is
gathered here, not the naive form.

Layouts: ``upsample_int`` takes channel-last images (..., H, W, C), as
its JAX counterpart does; the tile warps and ``warp_bounded`` take
planes (..., H, W), with the per-pixel fields broadcast over the leading
axes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multi_frame_super_resolution_tpu_torch.ops.filters import _const, _pad_edge


def _pad_last2(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Edge-replicate pad of the last two axes by (lo, hi) entries each.
    Every static shift by lo <= -d, d <= hi is then a view of the result
    (see _shifted), so a tap loop copies the image once."""
    return _pad_edge(_pad_edge(x, -2, lo, hi), -1, lo, hi)


def _shifted(xp: torch.Tensor, lo: int, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """View of out[..., y, x] = x[..., clamp(y + dy), clamp(x + dx)] from
    xp = _pad_last2(x, lo, hi)."""
    return xp[..., lo + dy : lo + dy + h, lo + dx : lo + dx + w]


def _phase_taps_1d(s: int, method: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-phase taps for integer-factor upsampling with the
    pixel-center convention src = (o + 0.5)/s - 0.5: (offsets (s, K),
    weights (s, K)), K = 2 (bilinear) or 4 (bicubic, a = -0.75)."""
    phases = (np.arange(s) + 0.5) / s - 0.5
    base = np.floor(phases).astype(np.int64)
    frac = phases - base
    if method == "bilinear":
        weights = np.stack([1.0 - frac, frac], axis=1)
        offsets = np.arange(2)
    elif method == "bicubic":
        a = -0.75

        def k(x):
            ax = np.abs(x)
            w1 = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
            w2 = ((a * ax - 5.0 * a) * ax + 8.0 * a) * ax - 4.0 * a
            return np.where(ax <= 1.0, w1, np.where(ax < 2.0, w2, 0.0))

        weights = np.stack([k(frac + 1.0), k(frac), k(1.0 - frac), k(2.0 - frac)], axis=1)
        offsets = np.arange(4) - 1
    else:
        raise ValueError(method)
    return base[:, None] + offsets[None, :], weights.astype(np.float32)


def upsample_int(img: torch.Tensor, s: int, method: str = "bilinear") -> torch.Tensor:
    """Integer-factor upsample of a channel-last image (..., H, W, C) with
    clamped borders, identical to resize(img, s*H, s*W, method).

    Per axis, one gather reads every (sample, phase, tap) source and the
    taps are summed in order: out[s*i + p] = sum_k w[p, k] x[i + o[p, k]]."""
    if s == 1:
        return img
    taps, weights = _phase_taps_1d(s, method)
    kk = taps.shape[1]
    dev = img.device

    def axis_upsample(x, axis):
        n = x.shape[axis]
        offsets = _const(tuple(taps.reshape(-1).tolist()), dev, torch.long).reshape(s, kk)
        idx = torch.arange(n, device=dev)[:, None, None] + offsets
        g = x.index_select(axis, idx.clamp_(0, n - 1).reshape(-1))
        rest = x.shape[axis + 1 :]
        g = g.reshape(x.shape[:axis] + (n, s, kk) + rest)
        wt = _const(tuple(weights.reshape(-1).tolist()), dev).reshape((s, kk) + (1,) * len(rest))
        acc = None
        for k in range(kk):
            term = g.select(axis + 2, k) * wt[:, k]
            acc = term if acc is None else acc + term
        return acc.reshape(x.shape[:axis] + (n * s,) + rest)

    out = axis_upsample(img, img.ndim - 3)
    return axis_upsample(out, img.ndim - 2)


def warp_bounded(img: torch.Tensor, flow: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Bilinear backward warp out(x) = img(x + flow(x)) of planes
    (..., H, W) for flows clamped to [-r, r]. ``flow`` is (..., H, W, 2)
    and broadcasts against the plane axes.

    The JAX function sums (2r+2)^2 static shifts with hat weights
    max(0, 1 - |f - d|); all but the 2 x 2 taps at floor(f) + {0, 1} have
    weight 0, so gathering those four with the same weights and adding in
    the same order gives the same floats."""
    h, w = img.shape[-2], img.shape[-1]
    fy = flow[..., 0].clamp(-r, r)
    fx = flow[..., 1].clamp(-r, r)
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = [(1.0 - (fy - d).abs()).clamp_min(0.0) for d in (y0, y0 + 1.0)]
    wx = [(1.0 - (fx - d).abs()).clamp_min(0.0) for d in (x0, x0 + 1.0)]
    dev = img.device
    ys = torch.arange(h, device=dev)[:, None] + y0.long()
    xs = torch.arange(w, device=dev) + x0.long()
    rows = [(ys + k).clamp_(0, h - 1) * w for k in (0, 1)]
    cols = [(xs + k).clamp_(0, w - 1) for k in (0, 1)]
    shape = torch.broadcast_shapes(img.shape, fy.shape)
    flat = img.expand(shape).reshape(shape[:-2] + (h * w,))

    def tap(i, j):
        idx = (rows[i] + cols[j]).expand(shape).reshape(shape[:-2] + (h * w,))
        return torch.gather(flat, -1, idx).reshape(shape)

    row0 = tap(0, 0) * wx[0] + tap(0, 1) * wx[1]
    row1 = tap(1, 0) * wx[0] + tap(1, 1) * wx[1]
    return row0 * wy[0] + row1 * wy[1]


def tile_shift_decompose(
    tile_shifts: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile float shifts -> (integer part, residual in [-0.5, 0.5]);
    rounds half to even, as jnp.round does."""
    rounded = torch.round(tile_shifts)
    return rounded.to(torch.int32), tile_shifts - rounded


def _repeat_tiles(x: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """(..., nty, ntx, C) -> (..., H, W, C): every tile entry repeated over
    its t x t pixels, cropped to (h, w). An expand and one copy:
    repeat_interleave would wait for the card to size its output."""
    nty, ntx, c = x.shape[-3:]
    lead = x.shape[:-3]
    rep = x[..., :, None, :, None, :].expand(lead + (nty, t, ntx, t, c))
    return rep.reshape(lead + (nty * t, ntx * t, c))[..., :h, :w, :]


def _onehot_shift_index(smap: torch.Tensor, bound: int, axis: int) -> torch.Tensor:
    """Source index along ``axis`` of ops/warp_fast.py::_axis_onehot_shift
    for the per-pixel integer map ``smap`` (..., H, W).

    Windows 2*bound+1 <= 13 are the direct select: src = clamp(p + s).
    Wider ones are the two-level decomposition s = c*q + r, r in [0, c):
    the coarse pass reads q at the fine-shifted position, with q extended
    past the last row (column) by its last value, so
    src = clamp(p + r(p) + c * q(min(p + r(p), n - 1))). Near tile
    borders this differs from clamp(p + s(p)) by design."""
    n = smap.shape[axis]
    shape = [1] * smap.ndim
    shape[axis] = n
    p = torch.arange(n, device=smap.device).reshape(shape)
    s = smap.long().clamp(-bound, bound)
    if 2 * bound + 1 <= 13:
        return (p + s).clamp(0, n - 1)
    c = max(2, int(np.round(np.sqrt(2 * bound + 1))))
    q = torch.div(s, c, rounding_mode="floor")
    r = s - c * q
    pr = p + r
    q_at = torch.gather(q, axis, pr.clamp(max=n - 1))
    return (pr + c * q_at).clamp(0, n - 1)


def tile_warp_select(
    img: torch.Tensor, int_shifts: torch.Tensor, tile_size: int, bound: int = 16
) -> torch.Tensor:
    """The function of ops/warp_fast.py::tile_warp_select on planes
    (..., H, W) with per-tile shifts (..., nty, ntx, 2): a row pass by the
    y-shift map, then a column pass by the x-shift map, each with the
    one-hot form's exact indexing (see _onehot_shift_index)."""
    h, w = img.shape[-2], img.shape[-1]
    smap = _repeat_tiles(int_shifts.long().clamp(-bound, bound), tile_size, h, w)
    out = torch.gather(img, -2, _onehot_shift_index(smap[..., 0], bound, -2).expand(img.shape))
    return torch.gather(out, -1, _onehot_shift_index(smap[..., 1], bound, -1).expand(img.shape))


def tile_warp_matmul(
    imgs: torch.Tensor, int_shifts: torch.Tensor, tile_size: int, bound: int = 16
) -> torch.Tensor:
    """The function of ops/warp_fast.py::tile_warp_matmul, as one gather.

    imgs (B, N, H, W): N planes sharing the shift field of their batch
    entry; int_shifts (B, nty, ntx, 2). The separable selector warp takes
    the y-shift from the SOURCE column's tile:
    out[y, x] = img[clamp(y + sy(ty(y), tx(x'))), x'] with
    x' = clamp(x + sx(ty(y), tx(x))).
    """
    b, n, h, w = imgs.shape
    t = tile_size
    ints = int_shifts.long().clamp(-bound, bound)
    dev = imgs.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    ty = ys // t
    sx = ints[:, ty, xs // t, 1]  # (B, H, W)
    xsrc = (xs + sx).clamp(0, w - 1)
    sy = torch.gather(ints[..., 0][:, ty.squeeze(1)], 2, xsrc // t)  # (B, H, W)
    ysrc = (ys + sy).clamp(0, h - 1)
    flat = (ysrc * w + xsrc).reshape(b, 1, h * w).expand(b, n, h * w)
    return torch.gather(imgs.reshape(b, n, h * w), 2, flat).reshape(b, n, h, w)
