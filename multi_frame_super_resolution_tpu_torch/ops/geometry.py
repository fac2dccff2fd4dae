"""Geometric ops (counterparts of ops/geometry.py): 2x2 mean decimation and
the bilinear resize with OpenCV pixel-center alignment."""

from __future__ import annotations

import torch


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool decimation of the last two axes of (..., H, W).
    Rows are averaged before columns, the order of the JAX 2-D form."""
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    x = img[..., : h2 * 2, : w2 * 2]
    rows = x.reshape(x.shape[:-2] + (h2, 2, w2 * 2)).mean(dim=-2)
    return rows.reshape(rows.shape[:-1] + (w2, 2)).mean(dim=-1)


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of a channel-last image (..., H, W, C) with clamped
    borders and src = (dst + 0.5) * scale - 0.5 (ops/geometry.py::resize
    with method="bilinear", through remap_bilinear)."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (w / out_w) - 0.5
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
