"""Warp primitives of the fast path (counterparts of ops/warp_fast.py).

The JAX package builds every warp from static shifts, one-hot selects
and selector matmuls because per-pixel gathers are slow on a TPU. A GPU
reads indexed loads at full rate, so the port computes the same
*functions* as direct index gathers. Where a TPU formulation defines a
function that differs from the naive one (the two-level one-hot warp,
the separable selector warp), the closed form of what it computes is
gathered here, not the naive form.

Layouts: the JAX names take the JAX call forms, images (H, W) or
(H, W, C) with fields (H, W, 2) or (nty, ntx, 2); ``upsample_int`` also
takes batches of channel-last images (..., H, W, C) and
``decompose_flow`` flows (..., H, W, 2). The pipelines' tile warps and
``warp_bounded_planes`` take planes (..., H, W), with the per-pixel
fields broadcast over the leading axes. ``tile_bounded_taps`` composes a
tile warp and a bounded warp into one set of gather taps that
``warp_taps`` applies, for fields that several images share.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from port_bench.reference.ops.filters import _const, _pad_edge


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


def upsample_nearest(img: torch.Tensor, s: int) -> torch.Tensor:
    """Each pixel of (H, W[, ...]) repeated over an s x s block."""
    return img.repeat_interleave(s, dim=0).repeat_interleave(s, dim=1)


def upsample_int(img: torch.Tensor, s: int, method: str = "bilinear") -> torch.Tensor:
    """Integer-factor upsample of an image (H, W) or (H, W, C), or of a
    batch of channel-last images (..., H, W, C), with clamped borders,
    identical to resize(img, s*H, s*W, method).

    Per axis, one gather reads every (sample, phase, tap) source and the
    taps are summed in order: out[s*i + p] = sum_k w[p, k] x[i + o[p, k]]."""
    if s == 1:
        return img
    if img.ndim == 2:
        return upsample_int(img[..., None], s, method)[..., 0]
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


def upsample_int_phases(img: torch.Tensor, s: int, method: str = "bilinear") -> torch.Tensor:
    """Phase-domain upsample of (H, W[, C]) -> (s, s, H, W[, C]):
    out[py, px, i, j] = upsample_int(img, s)[s*i + py, s*j + px]."""
    if s == 1:
        return img[None, None]
    h, w = img.shape[0], img.shape[1]
    up = upsample_int(img, s, method).reshape((h, s, w, s) + tuple(img.shape[2:]))
    return up.permute((1, 3, 0, 2) + tuple(range(4, up.ndim)))


def interleave_phases(p: torch.Tensor) -> torch.Tensor:
    """Phase planes (s, s, H, W[, C]) -> (s*H, s*W[, C])."""
    s, h, w = p.shape[0], p.shape[2], p.shape[3]
    trailing = tuple(p.shape[4:])
    return p.permute((2, 0, 3, 1) + tuple(range(4, p.ndim))).reshape((s * h, s * w) + trailing)


def upsample_int_phases_planes(img: torch.Tensor, s: int, method: str = "bilinear") -> torch.Tensor:
    """Channel-leading phase-domain upsample (H, W, C) -> (s, s, C, H, W):
    out[py, px, c, i, j] = upsample_int(img, s)[s*i + py, s*j + px, c],
    the same floats as the JAX per-phase tap sums."""
    h, w, c = img.shape
    up = upsample_int(img, s, method)
    return up.reshape(h, s, w, s, c).permute(1, 3, 4, 0, 2)


def interleave_phases_planes(p: torch.Tensor) -> torch.Tensor:
    """Channel-leading phase planes (s, s, C, H, W) -> (s*H, s*W, C): one
    permute and one copy. It stands in for interleave_phases_planes_mxu,
    whose 0/1 scatter matmuls exist for the TPU's layouts."""
    s, _, c, h, w = p.shape
    return p.permute(3, 0, 4, 1, 2).reshape(s * h, s * w, c)


def _bounded_taps(flow: torch.Tensor, r: int, h: int, w: int):
    """The 2 x 2 taps of ``warp_bounded`` for flows (..., H, W, 2): their
    flat source indices into an (H, W) plane, [i00, i01, i10, i11] each
    (..., H, W) and clamped into the plane, and the weights (wy, wx)."""
    fy = flow[..., 0].clamp(-r, r)
    fx = flow[..., 1].clamp(-r, r)
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = [(1.0 - (fy - d).abs()).clamp_min(0.0) for d in (y0, y0 + 1.0)]
    wx = [(1.0 - (fx - d).abs()).clamp_min(0.0) for d in (x0, x0 + 1.0)]
    dev = flow.device
    ys = torch.arange(h, device=dev)[:, None] + y0.long()
    xs = torch.arange(w, device=dev) + x0.long()
    rows = [(ys + k).clamp_(0, h - 1) * w for k in (0, 1)]
    cols = [(xs + k).clamp_(0, w - 1) for k in (0, 1)]
    return [rows[i] + cols[j] for i in (0, 1) for j in (0, 1)], wy, wx


def _gather_flat(img: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """img[..., index] for planes (..., H, W) and flat plane indices
    (..., H, W) that broadcast against each other."""
    h, w = img.shape[-2], img.shape[-1]
    shape = torch.broadcast_shapes(img.shape, index.shape)
    flat = img.expand(shape).reshape(shape[:-2] + (h * w,))
    return torch.gather(flat, -1, index.expand(shape).reshape(shape[:-2] + (h * w,))).reshape(shape)


def warp_taps(img: torch.Tensor, taps) -> torch.Tensor:
    """Planes (..., H, W) sampled at precomputed bilinear taps (indices,
    wy, wx) of ``_bounded_taps`` or ``tile_bounded_taps``, blended in
    warp_bounded's order."""
    index, wy, wx = taps
    t00, t01, t10, t11 = (_gather_flat(img, i) for i in index)
    row0 = t00 * wx[0] + t01 * wx[1]
    row1 = t10 * wx[0] + t11 * wx[1]
    return row0 * wy[0] + row1 * wy[1]


def warp_bounded_planes(img: torch.Tensor, flow: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Bilinear backward warp out(x) = img(x + flow(x)) of planes
    (..., H, W) for flows clamped to [-r, r]. ``flow`` is (..., H, W, 2)
    and broadcasts against the plane axes.

    The JAX function sums (2r+2)^2 static shifts with hat weights
    max(0, 1 - |f - d|); all but the 2 x 2 taps at floor(f) + {0, 1} have
    weight 0, so gathering those four with the same weights and adding in
    the same order gives the same floats."""
    return warp_taps(img, _bounded_taps(flow, r, img.shape[-2], img.shape[-1]))


def warp_bounded(img: torch.Tensor, flow: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Bilinear backward warp of an image (H, W) or (H, W, C) by a flow
    (H, W, 2) clamped to [-r, r] (ops/warp_fast.py::warp_bounded)."""
    if img.ndim not in (2, 3):
        raise ValueError(
            f"warp_bounded takes (H, W) or (H, W, C) images, as the JAX function does, got shape "
            f"{tuple(img.shape)}; use warp_bounded_planes for planes (..., H, W)"
        )
    if img.ndim == 2:
        return warp_bounded_planes(img, flow, r)
    return torch.movedim(warp_bounded_planes(torch.movedim(img, -1, 0), flow, r), 0, -1)


def tile_shift_decompose(
    tile_shifts: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile float shifts -> (integer part, residual in [-0.5, 0.5]);
    rounds half to even, as jnp.round does."""
    rounded = torch.round(tile_shifts)
    return rounded.to(torch.int32), tile_shifts - rounded


def decompose_flow(flow: torch.Tensor, tile_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split dense flows (..., H, W, 2) into per-tile integer parts (the
    tile mean rounded half to even, (..., nty, ntx, 2) int32) and per-pixel
    residuals (..., H, W, 2). Ragged edge tiles are edge-padded before the
    mean, as ops/warp_fast.py::decompose_flow pads them."""
    h, w = flow.shape[-3], flow.shape[-2]
    t = tile_size
    nty, ntx = -(-h // t), -(-w // t)
    f = _pad_edge(_pad_edge(flow, -3, 0, nty * t - h), -2, 0, ntx * t - w)
    tile_mean = f.reshape(flow.shape[:-3] + (nty, t, ntx, t, 2)).mean(dim=(-4, -2))
    tile_int = torch.round(tile_mean).to(torch.int32)
    return tile_int, flow - _repeat_tiles(tile_int.to(flow.dtype), t, h, w)


def tile_warp_int(img: torch.Tensor, int_shifts: torch.Tensor, tile_size: int) -> torch.Tensor:
    """Warp of a float32 image (H, W) or (H, W, C) by a per-tile integer
    shift (ops/warp_fast.py::tile_warp_int): out[y, x] = img[clamp(y + sy),
    clamp(x + sx)], (sy, sx) the shift of the tile of (y, x), from
    int_shifts (nty, ntx, 2) over the ceil-divided tile grid, not clipped.

    It runs the block map (``tile_warp_block``), which clamps a tile's
    origin, not each pixel, so the image is edge-padded first by P rows (and P' columns), multiples of
    the tile size at least the largest shift: no block origin then
    leaves the padded image, and the padded image's edge rows are the
    per-pixel clamp. A shift past the image's extent is cut to it first,
    which changes no clamped index. Reading the largest shift is one
    device-to-host copy."""
    if img.ndim not in (2, 3):
        raise ValueError(f"tile_warp_int takes (H, W) or (H, W, C) images, got shape {tuple(img.shape)}")
    h, w = img.shape[0], img.shape[1]
    t = tile_size
    nty, ntx = -(-h // t), -(-w // t)
    if int_shifts.ndim != 3 or int_shifts.shape[0] < nty or int_shifts.shape[1] < ntx or int_shifts.shape[2] != 2:
        raise ValueError(
            f"int_shifts must be ({nty}, {ntx}, 2) for {h} x {w} at tile {t}, got {tuple(int_shifts.shape)}"
        )
    ints = torch.as_tensor(int_shifts, device=img.device)[:nty, :ntx].long()
    sy = ints[..., 0].clamp(-(h - 1), h - 1)
    sx = ints[..., 1].clamp(-(w - 1), w - 1)
    most_y, most_x = torch.stack([sy.abs().amax(), sx.abs().amax()]).tolist()
    py, px = t * -(-most_y // t), t * -(-most_x // t)
    planes = img[None] if img.ndim == 2 else torch.movedim(img, -1, 0)
    padded = _pad_edge(_pad_edge(planes, -2, py, py + nty * t - h), -1, px, px + ntx * t - w)
    shifts = torch.zeros(
        (1, nty + 2 * py // t, ntx + 2 * px // t, 2), dtype=torch.int32, device=img.device
    )
    shifts[0, py // t : py // t + nty, px // t : px // t + ntx] = torch.stack([sy, sx], -1).to(torch.int32)
    out = tile_warp_block(padded[None].contiguous(), shifts, t)[0]
    out = out[:, py : py + h, px : px + w]
    return out[0] if img.ndim == 2 else torch.movedim(out, 0, -1)


def _repeat_tiles(x: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """(..., nty, ntx, C) -> (..., H, W, C): every tile entry repeated over
    its t x t pixels, cropped to (h, w). An expand and one copy:
    repeat_interleave would wait for the card to size its output."""
    nty, ntx, c = x.shape[-3:]
    lead = x.shape[:-3]
    rep = x[..., :, None, :, None, :].expand(lead + (nty, t, ntx, t, c))
    return rep.reshape(lead + (nty * t, ntx * t, c))[..., :h, :w, :]


def onehot_coarse(bound: int) -> int:
    """The one-hot form's coarse step at ``bound``: 0, the direct select,
    for a window 2 bound + 1 <= 13, else round(sqrt(2 bound + 1)), at
    least 2 (the JAX package's ops/warp_fast.py::_axis_onehot_shift)."""
    return 0 if 2 * bound + 1 <= 13 else max(2, int(np.round(np.sqrt(2 * bound + 1))))


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
    c = onehot_coarse(bound)
    if not c:
        return (p + s).clamp(0, n - 1)
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


def tile_bounded_taps(
    int_shifts: torch.Tensor, residual: torch.Tensor, tile_size: int, r: int, h: int, w: int, bound: int = 16
):
    """The taps of warp_bounded(tile_warp_select(img, int_shifts,
    tile_size, bound), residual, r) for (H, W) planes, composed once for
    fields that several images share: each bilinear tap's source is
    looked up through the tile warp's source map, so ``warp_taps`` then
    takes four gathers of the image and returns the same floats as the
    two warps. int_shifts (..., nty, ntx, 2), residual (..., H, W, 2)."""
    smap = _repeat_tiles(int_shifts.long().clamp(-bound, bound), tile_size, h, w)
    ix = _onehot_shift_index(smap[..., 1], bound, -1)
    # tile_warp_select's output at (y, x) is img[iy(y, ix(y, x)), ix(y, x)]
    src = torch.gather(_onehot_shift_index(smap[..., 0], bound, -2), -1, ix) * w + ix
    index, wy, wx = _bounded_taps(residual, r, h, w)
    return [_gather_flat(src, i) for i in index], wy, wx


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


def tile_warp_block(imgs: torch.Tensor, int_shifts: torch.Tensor, tile_size: int) -> torch.Tensor:
    """The function of pallas_ops/tile_warp.py::tile_warp_pallas: a block
    copy per tile with the block origin clamped into the image.

    imgs (B, N, H, W) with H and W multiples of the tile size, N planes
    sharing the shift field of their batch entry; int_shifts
    (B, nty, ntx, 2), not clipped. out[ty*T + i, tx*T + j] =
    img[y0 + i, x0 + j] with y0 = clip(ty*T + sy, 0, H - T) and
    x0 = clip(tx*T + sx, 0, W - T)."""
    b, n, h, w = imgs.shape
    t = tile_size
    if h % t or w % t:
        raise ValueError(f"the block tile warp needs H and W multiples of {t}, got {h}x{w}")
    dev = imgs.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    ints = int_shifts.long()
    y0 = (ys // t * t + ints[:, ys // t, xs // t, 0]).clamp(0, h - t)  # (B, H, W)
    x0 = (xs // t * t + ints[:, ys // t, xs // t, 1]).clamp(0, w - t)
    flat = ((y0 + ys % t) * w + x0 + xs % t).reshape(b, 1, h * w).expand(b, n, h * w)
    return torch.gather(imgs.reshape(b, n, h * w), 2, flat).reshape(b, n, h, w)


def default_warp_bound(h: int, w: int) -> int:
    """Shift clamp of similarity_warp_fast (ops/warp_fast.py::
    default_warp_bound): ~20-degree corner displacement plus ~24 px of
    translation at this image size. Validity masks test |src - pos|
    against the same bound."""
    return int(np.ceil(0.35 * float(np.hypot(h / 2.0, w / 2.0)))) + 24


def _axis_linear_resample(
    img: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, axis: int, bound: int
) -> torch.Tensor:
    """The function of ops/warp_fast.py::_axis_linear_resample: a 1-D
    linear resample of planes (..., H, W) along image axis ``axis``
    (0: rows, 1: columns) at an affine source map, given by its values
    ``lo`` and ``hi`` (..., lines) at the first and last position of
    every line along the axis; written as three gathers.

    The JAX form reads the map off those ends: a stretch
    t(p) = clip((slope - 1)(p - center), +-rb) shared by all lines, with
    slope from line 0, and a per-line offset c = (lo + hi) / 2 - center.
    It shifts each line by hoist = clip(floor(c), +-bound) (the one-hot
    pass), then samples the taps floor(p + t) + {0, 1, 2} and blends them
    at s = frac(p + t) + clip(c - hoist, 0, 1) in [0, 2), piecewise
    linear with the knee at 1. Every tap index is clamped into the axis
    (replicate border)."""
    size = img.shape[-1] if axis == 1 else img.shape[-2]
    rb = max(6, int(np.ceil(0.07 * size / 2.0)))
    slope = (hi[..., :1] - lo[..., :1]) / float(max(size - 1, 1))
    center = (size - 1) / 2.0
    p = torch.arange(size, dtype=torch.float32, device=img.device)
    t = ((slope - 1.0) * (p - center)).clamp(-rb, rb)  # (..., size)
    c = (lo + hi) * 0.5 - center  # (..., lines)
    hoist = torch.floor(c).clamp(-bound, bound)
    phi = (c - hoist).clamp(0.0, 1.0)
    pt = p + t
    base = torch.floor(pt)
    f = pt - base
    if axis == 1:  # (..., lines = H, size = W)
        pos = base.long()[..., None, :] + hoist.long()[..., :, None]
        s = f[..., None, :] + phi[..., :, None]
        dim = -1
    else:  # (..., size = H, lines = W)
        pos = base.long()[..., :, None] + hoist.long()[..., None, :]
        s = f[..., :, None] + phi[..., None, :]
        dim = -2
    shape = torch.broadcast_shapes(img.shape, pos.shape)
    src = img.expand(shape)

    def tap(k):
        return torch.gather(src, dim, (pos + k).clamp_(0, size - 1).expand(shape))

    e0, e1, e2 = tap(0), tap(1), tap(2)
    return torch.where(s < 1.0, e0 * (1.0 - s) + e1 * s, e1 * (2.0 - s) + e2 * (s - 1.0))


def similarity_warp_fast(
    img: torch.Tensor,
    src_y: torch.Tensor,
    src_x: torch.Tensor,
    bound: int | None = None,
    batch_dims: int = 0,
) -> torch.Tensor:
    """The function of ops/warp_fast.py::similarity_warp_fast on planes
    (..., H, W) with affine source grids (..., H, W) that broadcast
    against their leading axes: the two-pass (Catmull-Smith) resample, a
    1-D x pass at u(y', x), the x-source of the point on row y' that
    lands on output column x, then a 1-D y pass at src_y. The affine
    coefficients are the grids' finite differences, in float32, as the
    JAX function reads them. It differs from a bilinear ``remap`` on
    rotations (up to ~0.2 at 15 degrees), so it is not computed as one.
    ``batch_dims`` is taken for the JAX call form ((batch..., H, W) planes
    sharing (H, W) grids); here every leading axis broadcasts anyway."""
    h, w = img.shape[-2], img.shape[-1]
    if bound is None:
        bound = default_warp_bound(h, w)
    a_yy = (src_y[..., 1, 0] - src_y[..., 0, 0])[..., None, None]
    a_yx = (src_y[..., 0, 1] - src_y[..., 0, 0])[..., None, None]
    e_y = src_y[..., 0, 0][..., None, None]
    a_xy = (src_x[..., 1, 0] - src_x[..., 0, 0])[..., None, None]
    a_xx = (src_x[..., 0, 1] - src_x[..., 0, 0])[..., None, None]
    e_x = src_x[..., 0, 0][..., None, None]
    dev = img.device
    # each pass reads its map at the first and last position of a line
    # only, so only those entries of u and v are computed
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    x_ends = _const((0.0, w - 1.0), dev)[None, :]
    safe_a_yy = torch.where(a_yy.abs() > 1e-6, a_yy, 1.0)
    u = a_xy * (ys - a_yx * x_ends - e_y) / safe_a_yy + a_xx * x_ends + e_x  # (..., H, 2)
    tmp = _axis_linear_resample(img, u[..., 0], u[..., 1], axis=1, bound=bound)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    y_ends = _const((0.0, h - 1.0), dev)[:, None]
    v = a_yy * y_ends + a_yx * xs + e_y  # (..., 2, W)
    return _axis_linear_resample(tmp, v[..., 0, :], v[..., 1, :], axis=0, bound=bound)
