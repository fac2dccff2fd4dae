"""Geometric ops (counterparts of ops/geometry.py): 2x2 mean decimation,
the resize with OpenCV pixel-center alignment (and ``downscale``), the
zero-stuffing upsample, remaps at float coordinates (bilinear, bicubic,
nearest) with replicate borders, the backward warp by a dense flow, and
the rotation about the image center.

Coordinates follow the pixel-index convention: an integer coordinate is
a pixel center.

Layouts: the JAX names take the JAX call forms, images (H, W) or
(H, W, C); ``resize``, ``upscale`` and ``downscale`` also take batches of
channel-last images (..., H, W, C). The ``_planes`` names take planes
(..., H, W), the layout the pipelines use: ``remap_planes`` and
``warp_backward_planes`` with coordinate grids or flows that broadcast
against their leading axes, ``downsample2_planes`` also batches of
channel-last images (``channel_last=True``)."""

from __future__ import annotations

import numpy as np
import torch


def downsample2_planes(img: torch.Tensor, channel_last: bool = False) -> torch.Tensor:
    """2x2 average-pool decimation of the last two axes of planes
    (..., H, W). Rows are averaged before columns, the order of the JAX
    2-D form. With ``channel_last``, of images (..., H, W, C), the four
    samples averaged at once as the JAX form does for (H, W, C)."""
    if channel_last:
        h2, w2 = img.shape[-3] // 2, img.shape[-2] // 2
        x = img[..., : 2 * h2, : 2 * w2, :]
        return x.reshape(x.shape[:-3] + (h2, 2, w2, 2, x.shape[-1])).mean(dim=(-4, -2))
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., : h2 * 2, : w2 * 2]
    rows = x.reshape(x.shape[:-2] + (h2, 2, w2 * 2)).mean(dim=-2)
    return rows.reshape(rows.shape[:-1] + (w2, 2)).mean(dim=-1)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool decimation of an image (H, W) or (H, W, C)
    (ops/geometry.py::downsample2)."""
    if img.ndim not in (2, 3):
        raise ValueError(
            f"downsample2 takes (H, W) or (H, W, C) images, as the JAX function does, got shape "
            f"{tuple(img.shape)}; use downsample2_planes for planes (..., H, W)"
        )
    return downsample2_planes(img, channel_last=img.ndim == 3)


def resize(img: torch.Tensor, out_h: int, out_w: int, method: str = "bilinear") -> torch.Tensor:
    """Resize of an image (H, W) or (H, W, C), or of a batch of
    channel-last images (..., H, W, C), with OpenCV pixel-center
    alignment, src = (dst + 0.5) * scale - 0.5, and clamped borders
    (ops/geometry.py::resize). Bilinear reads rows, then columns, by index
    (the values of remap_bilinear); bicubic and nearest go through
    ``remap_planes``."""
    if img.ndim == 2:
        return resize(img[..., None], out_h, out_w, method)[..., 0]
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (w / out_w) - 0.5
    if method != "bilinear":
        planes = remap_planes(
            torch.movedim(img, -1, -3), ys[:, None].expand(out_h, out_w),
            xs[None, :].expand(out_h, out_w), method,
        )
        return torch.movedim(planes, -3, -1)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    fy = (ys - y0.to(ys.dtype))[:, None, None]
    fx = (xs - x0.to(xs.dtype))[:, None]

    def rows(yi):
        return img.index_select(-3, yi.clamp(0, h - 1))

    def cols(x, xi):
        return x.index_select(-2, xi.clamp(0, w - 1))

    r0, r1 = rows(y0), rows(y0 + 1)
    p00, p01 = cols(r0, x0), cols(r0, x0 + 1)
    p10, p11 = cols(r1, x0), cols(r1, x0 + 1)
    top = p00 + (p01 - p00) * fx
    bot = p10 + (p11 - p10) * fx
    return top + (bot - top) * fy


def upscale(img: torch.Tensor, scale: int, method: str = "bicubic") -> torch.Tensor:
    """``resize`` of (H, W), (H, W, C) or (..., H, W, C) by an integer
    factor (ops/geometry.py::upscale)."""
    if img.ndim == 2:
        return resize(img, img.shape[0] * scale, img.shape[1] * scale, method)
    return resize(img, img.shape[-3] * scale, img.shape[-2] * scale, method)


def downscale(img: torch.Tensor, scale: int, method: str = "bilinear") -> torch.Tensor:
    """``resize`` of (H, W) or (H, W, C) to (H // scale, W // scale)
    (ops/geometry.py::downscale)."""
    if img.ndim == 2:
        return downscale(img[..., None], scale, method)[..., 0]
    return resize(img, img.shape[0] // scale, img.shape[1] // scale, method)


def upsample_zero(img: torch.Tensor, scale: int) -> torch.Tensor:
    """Zero-stuffing upsample of (H, W) or (H, W, C), the transpose of
    strided decimation: img at every ``scale``-th row and column, zeros
    elsewhere (ops/geometry.py::upsample_zero)."""
    h, w = img.shape[0], img.shape[1]
    out = img.new_zeros((h * scale, w * scale) + tuple(img.shape[2:]))
    out[::scale, ::scale] = img
    return out


def _gather_planes(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img[..., clamp(yi), clamp(xi)] for planes (..., H, W) and integer
    grids (..., Ho, Wo) that broadcast against the leading axes."""
    h, w = img.shape[-2], img.shape[-1]
    flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    lead = torch.broadcast_shapes(img.shape[:-2], flat.shape[:-2])
    out_hw = flat.shape[-2:]
    src = img.expand(lead + (h, w)).reshape(lead + (h * w,))
    idx = flat.expand(lead + out_hw).reshape(lead + (-1,))
    return torch.gather(src, -1, idx).reshape(lead + out_hw)


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """OpenCV-convention cubic convolution weights of the 4 taps around a
    sample with fractional offset t in [0, 1)."""

    def k(x):
        ax = x.abs()
        w1 = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
        w2 = ((a * ax - 5.0 * a) * ax + 8.0 * a) * ax - 4.0 * a
        return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, 0.0))

    return [k(t + 1.0), k(t), k(1.0 - t), k(2.0 - t)]


def remap_planes(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """Sample planes ``img`` (..., H, W) at float coordinates (ys, xs)
    (..., Ho, Wo) with clamped (replicate) borders; the taps are summed
    in the order of ops/geometry.py's remap_bilinear / remap_bicubic."""
    if method == "nearest":
        return _gather_planes(img, torch.round(ys).long(), torch.round(xs).long())
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown method {method!r}")
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0 = y0.long()
    x0 = x0.long()
    if method == "bilinear":
        p00 = _gather_planes(img, y0, x0)
        p01 = _gather_planes(img, y0, x0 + 1)
        p10 = _gather_planes(img, y0 + 1, x0)
        p11 = _gather_planes(img, y0 + 1, x0 + 1)
        top = p00 + (p01 - p00) * fx
        bot = p10 + (p11 - p10) * fx
        return top + (bot - top) * fy
    wy = _cubic_weights(fy)
    wx = _cubic_weights(fx)
    out = None
    for i, wyi in enumerate(wy):
        row = None
        for j, wxj in enumerate(wx):
            term = _gather_planes(img, y0 + (i - 1), x0 + (j - 1)) * wxj
            row = term if row is None else row + term
        term = row * wyi
        out = term if out is None else out + term
    return out


def remap(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """Sample ``img`` (H, W) or (H, W, C) at float coordinates (ys, xs) of
    any one shape S: output S or S + (C,) (ops/geometry.py::remap)."""
    if img.ndim not in (2, 3):
        raise ValueError(
            f"remap takes (H, W) or (H, W, C) images, as the JAX function does, got shape "
            f"{tuple(img.shape)}; use remap_planes for planes (..., H, W)"
        )
    shape = ys.shape
    if ys.ndim != 2:
        ys, xs = ys.reshape(1, -1), xs.reshape(1, -1)
    if img.ndim == 2:
        return remap_planes(img, ys, xs, method).reshape(shape)
    out = torch.movedim(remap_planes(torch.movedim(img, -1, 0), ys, xs, method), 0, -1)
    return out.reshape(shape + (img.shape[-1],))


def remap_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear ``remap`` with clamped borders (ops/geometry.py::remap_bilinear)."""
    return remap(img, ys, xs, "bilinear")


def remap_bicubic(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bicubic (a = -0.75, OpenCV INTER_CUBIC) ``remap`` with clamped
    borders (ops/geometry.py::remap_bicubic)."""
    return remap(img, ys, xs, "bicubic")


def identity_grid(h: int, w: int, dtype: torch.dtype = torch.float32, device=None):
    """(ys, xs) pixel-center index grids of shape (h, w)."""
    ys = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    return ys, xs


def warp_backward_planes(img: torch.Tensor, flow: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """Backward warp of planes (..., H, W) by dense flows (..., H, W, 2)
    ordered (dy, dx): out(p) = img(p + flow(p)), replicate border. The
    flows broadcast against the planes' leading axes."""
    h, w = img.shape[-2], img.shape[-1]
    ys, xs = identity_grid(h, w, flow.dtype, img.device)
    return remap_planes(img, ys + flow[..., 0], xs + flow[..., 1], method)


def warp_backward(img: torch.Tensor, flow: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """Backward warp of an image (H, W) or (H, W, C) by a dense flow
    (H, W, 2) ordered (dy, dx): out(p) = img(p + flow(p)), replicate
    border (ops/geometry.py::warp_backward)."""
    if img.ndim not in (2, 3):
        raise ValueError(
            f"warp_backward takes (H, W) or (H, W, C) images, as the JAX function does, got shape "
            f"{tuple(img.shape)}; use warp_backward_planes for planes (..., H, W)"
        )
    if img.ndim == 2:
        return warp_backward_planes(img, flow, method)
    return torch.movedim(warp_backward_planes(torch.movedim(img, -1, 0), flow, method), 0, -1)


def translate(img: torch.Tensor, dy, dx, method: str = "bilinear") -> torch.Tensor:
    """Sample img (H, W[, C]) at (y + dy, x + dx): shifts the scene by
    (-dy, -dx)."""
    ys, xs = identity_grid(img.shape[0], img.shape[1], device=img.device)
    return remap(img, ys + dy, xs + dx, method)


def rotate(
    img: torch.Tensor,
    angle_rad: float,
    method: str = "bicubic",
    center: tuple | None = None,
    expand: bool = False,
) -> torch.Tensor:
    """Rotate (H, W) or (H, W, C) about the image center
    (ops/geometry.py::rotate, the NPP rotate demo, main.cpp:394-497).

    ``expand=False`` keeps the output size (content clipped at corners).
    ``expand=True`` grows the canvas to the rotated bounding box, the
    content centered; ``angle_rad`` is then a Python scalar and ``center``
    is ignored. The sine and cosine are float32, as in the JAX package."""
    h, w = img.shape[0], img.shape[1]
    if expand:
        a = float(angle_rad)
        ca_a, sa_a = abs(np.cos(a)), abs(np.sin(a))
        # epsilon guards exact multiples of 90 deg, where the rotated
        # extent lands on an integer up to f64 rounding
        oh = int(np.ceil(h * ca_a + w * sa_a - 1e-9))
        ow = int(np.ceil(w * ca_a + h * sa_a - 1e-9))
        cy_in, cx_in = (h - 1) / 2.0, (w - 1) / 2.0
        cy_out, cx_out = (oh - 1) / 2.0, (ow - 1) / 2.0
    else:
        oh, ow = h, w
        cy_in, cx_in = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else center
        cy_out, cx_out = cy_in, cx_in
    ys, xs = identity_grid(oh, ow, device=img.device)
    angle = torch.as_tensor(angle_rad, dtype=torch.float32, device=img.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    yr = ys - cy_out
    xr = xs - cx_out
    src_y = cy_in + sa * xr + ca * yr
    src_x = cx_in + ca * xr - sa * yr
    return remap(img, src_y, src_x, method)
