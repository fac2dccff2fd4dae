"""Linear filters: separable correlation, box and Gaussian filters, the
depthwise 2-D correlation, the Laplacian sharpen and the unsharp mask
(counterparts of ops/filters.py).

The JAX package lowers these to banded matmuls for the TPU's matrix unit;
here each 1-D pass is a window sum over a padded axis, which is the same
function (the band matrix bakes the border in exactly as padding does).
Only the order of the f32 additions differs.

Layouts: the JAX names take the JAX call forms, images (H, W) or
(H, W, C) filtered over axes 0 and 1. The ``_planes`` names
(``separable_filter_planes``, ``gaussian_blur_planes``,
``box_filter_planes``) filter the last two axes of planes (..., H, W),
the layout the pipelines use.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

# above this edge length the JAX package leaves the banded-matmul forms
# (ops/filters.py:_BAND_MATMUL_MAX_DIM); the bf16 box path follows it
_BAND_MATMUL_MAX_DIM = 1024


@functools.lru_cache(maxsize=None)
def _const_array(make, args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)`` (a numpy array or a CPU tensor) on ``device``, made
    and copied there once per process: a copy from pageable host memory
    would stall the host until the card has drained its queue, on every
    call."""
    return torch.as_tensor(make(*args)).contiguous().to(device)


def _const(values: tuple, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small constant ``values`` on ``device`` (see ``_const_array``)."""
    return _const_array(_tensor, (values, dtype), device)


def _tensor(values: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype)


def gaussian_kernel_1d(sigma: float, size: int | None = None) -> np.ndarray:
    """Normalized 1-D Gaussian taps (float32 numpy), computed in float64;
    ``size`` defaults to 2*ceil(3*sigma)+1 and is made odd."""
    if size is None:
        size = 2 * int(math.ceil(3.0 * sigma)) + 1
    if size % 2 == 0:
        size += 1
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _pad_edge(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Edge-replicate pad of one axis by (lo, hi) entries (one copy; the
    edge entries are broadcast views)."""
    if lo == 0 and hi == 0:
        return x
    n = x.shape[axis]
    parts = [x]
    for count, edge, at in ((lo, 0, 0), (hi, n - 1, 2)):
        if count:
            shape = list(x.shape)
            shape[axis] = count
            parts.insert(at, x.narrow(axis, edge, 1).expand(shape))
    return torch.cat(parts, dim=axis)


def _pad_zero(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero pad of one axis by (lo, hi) entries."""
    if lo == 0 and hi == 0:
        return x
    pads = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [lo, hi]
    return torch.nn.functional.pad(x, pads)


def _pad(x: torch.Tensor, axis: int, lo: int, hi: int, border: str) -> torch.Tensor:
    if border == "replicate":
        return _pad_edge(x, axis, lo, hi)
    if border == "zero":
        return _pad_zero(x, axis, lo, hi)
    raise ValueError(f"border must be 'replicate' or 'zero', got {border!r}")


def _windows(x: torch.Tensor, size: int, axis: int, border: str = "replicate") -> torch.Tensor:
    """Padded sliding windows of ``size`` taps at offsets
    -size//2 .. size-1-size//2 along ``axis``, as a trailing dim."""
    axis = axis % x.ndim
    r = size // 2
    return _pad(x, axis, r, size - 1 - r, border).unfold(axis, size, 1)


def _filter_axis(x: torch.Tensor, taps, axis: int, border: str = "replicate") -> torch.Tensor:
    """1-D correlation out[i] = sum_t taps[t] * x[border(i + t - r)] along
    ``axis`` (the band matrix of ops/filters.py::_band_matrix): the index
    clamped for ``border="replicate"``, the sample 0 outside for
    ``"zero"``. ``taps`` is numpy or a tensor, on any device."""
    if isinstance(taps, torch.Tensor):
        t = taps.to(x.device, torch.float32).reshape(-1)
    else:
        t = _const(tuple(np.asarray(taps, np.float32).reshape(-1).tolist()), x.device)
    return (_windows(x, t.numel(), axis, border) * t).sum(-1)


def _image_as_planes(img: torch.Tensor, who: str, planes_name: str) -> torch.Tensor:
    """An image of the JAX call forms, (H, W) or (H, W, C), as planes
    (H, W) or (C, H, W); other ranks raise, naming the planes form."""
    if img.ndim == 2:
        return img
    if img.ndim == 3:
        return torch.movedim(img, -1, 0)
    raise ValueError(
        f"{who} takes (H, W) or (H, W, C) images, as the JAX function does, got shape "
        f"{tuple(img.shape)}; use {planes_name} for planes (..., H, W)"
    )


def _planes_as_image(planes: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    return planes if img.ndim == 2 else torch.movedim(planes, 0, -1)


def separable_filter_planes(img: torch.Tensor, ky, kx, border: str = "replicate") -> torch.Tensor:
    """Separable correlation of the LAST TWO axes of planes (..., H, W)
    (rows, then columns); ``border`` "replicate" or "zero"."""
    return _filter_axis(_filter_axis(img, ky, -2, border), kx, -1, border)


def separable_filter(img: torch.Tensor, ky, kx, border: str = "replicate") -> torch.Tensor:
    """Separable correlation of an image (H, W) or (H, W, C) along its
    rows (axis 0), then its columns (axis 1), each channel alone
    (ops/filters.py::separable_filter); ``border`` "replicate" (clamped)
    or "zero"."""
    planes = _image_as_planes(img, "separable_filter", "separable_filter_planes")
    return _planes_as_image(separable_filter_planes(planes, ky, kx, border), img)


def gaussian_blur_planes(img: torch.Tensor, sigma: float, size: int | None = None) -> torch.Tensor:
    """Gaussian blur of the last two axes of planes (..., H, W), replicate
    border."""
    k = gaussian_kernel_1d(sigma, size)
    return separable_filter_planes(img, k, k)


def gaussian_blur(img: torch.Tensor, sigma: float, size: int | None = None) -> torch.Tensor:
    """Gaussian blur of an image (H, W) or (H, W, C) over axes 0 and 1,
    replicate border (ops/filters.py::gaussian_blur)."""
    planes = _image_as_planes(img, "gaussian_blur", "gaussian_blur_planes")
    return _planes_as_image(gaussian_blur_planes(planes, sigma, size), img)


def conv2d(img: torch.Tensor, kernel, border: str = "replicate") -> torch.Tensor:
    """Depthwise 2-D correlation (ops/filters.py::conv2d): ``kernel``
    (kh, kw), shared by the channels of (H, W), (H, W, C) or
    (N, H, W, C). ``border="replicate"`` edge-pads kh // 2 rows and
    kw // 2 columns on each side and keeps the valid outputs;
    ``"zero"`` is the SAME correlation over zeros ((k - 1) // 2 before,
    the rest after). Both give (H, W) for odd kernels. The taps are
    summed in float32, row by row, on the device of ``img``."""
    if img.ndim == 2:
        x = img
    elif img.ndim in (3, 4):
        x = torch.movedim(img, -1, -3)
    else:
        raise ValueError(f"conv2d takes (H, W), (H, W, C) or (N, H, W, C), got shape {tuple(img.shape)}")
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    if k.ndim != 2:
        raise ValueError(f"conv2d takes a (kh, kw) kernel, got shape {tuple(k.shape)}")
    kh, kw = k.shape
    if border == "replicate":
        lo_y, hi_y, lo_x, hi_x = kh // 2, kh // 2, kw // 2, kw // 2
    elif border == "zero":
        lo_y, lo_x = (kh - 1) // 2, (kw - 1) // 2
        hi_y, hi_x = kh - 1 - lo_y, kw - 1 - lo_x
    else:
        raise ValueError(f"border must be 'replicate' or 'zero', got {border!r}")
    xp = _pad(_pad(x, -2, lo_y, hi_y, border), -1, lo_x, hi_x, border)
    oh, ow = xp.shape[-2] - kh + 1, xp.shape[-1] - kw + 1
    out = None
    for u in range(kh):
        for v in range(kw):
            term = xp[..., u : u + oh, v : v + ow] * k[u, v]
            out = term if out is None else out + term
    return out if img.ndim == 2 else torch.movedim(out, -3, -1)


def unsharp_mask(img: torch.Tensor, sigma: float = 1.0, amount: float = 1.0) -> torch.Tensor:
    """Unsharp masking of (H, W) or (H, W, C) (ops/filters.py::unsharp_mask,
    sharpenImg in main.cpp:507-535): clip(img + amount (img - blur))."""
    return (img + amount * (img - gaussian_blur(img, sigma))).clamp(0.0, 1.0)


def laplacian_sharpen(img: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian sharpen of (H, W) or (H, W, C) (sharpenImg2):
    clamp(5 c - up - left - right - down) on the edge-padded image with the
    1-px border set to 0. The terms are added in the grouping the JAX
    package's jitted conv gives on the CPU, ((5 c - right) - up) +
    (-down - left), so the two agree bit for bit."""
    planes = img if img.ndim == 2 else torch.movedim(img, -1, 0)
    h, w = planes.shape[-2], planes.shape[-1]
    xp = _pad_edge(_pad_edge(planes, -2, 1, 1), -1, 1, 1)

    def at(dy, dx):
        return xp[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    out = ((5.0 * at(0, 0) - at(0, 1)) - at(-1, 0)) + (-at(1, 0) - at(0, -1))
    out = out.clamp(0.0, 1.0)
    inner = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    inner[1:-1, 1:-1] = True
    out = torch.where(inner, out, 0.0)
    return out if img.ndim == 2 else torch.movedim(out, 0, -1)


def _window_sum(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    return _windows(x, size, axis).sum(-1)


def _sliding_sum(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Edge-padded cumsum difference (the wide-window form of
    ops/filters.py::box_filter_planes)."""
    axis = axis % x.ndim
    r = size // 2
    n = x.shape[axis]
    cs = torch.cumsum(_pad_edge(x, axis, r + 1, r), dim=axis)
    return cs.narrow(axis, size, n) - cs.narrow(axis, 0, n)


def box_filter_planes(
    x: torch.Tensor, size: int, normalize: bool = True, mxu_bf16: bool = False
) -> torch.Tensor:
    """Box filter over the last two axes of (..., H, W), replicate border.

    ``mxu_bf16`` reproduces the JAX package's bfloat16 banded matmuls
    (ops/filters.py:214-225): the input is rounded to bf16, the column
    (H) sums run in f32, the partial sums are rounded to bf16 again, and
    the row (W) sums run in f32. Both roundings matter: without them the
    Lucas-Kanade window sums drift by ~2^-8 relative.
    """
    h, w = x.shape[-2], x.shape[-1]
    if mxu_bf16 and max(h, w) <= _BAND_MATMUL_MAX_DIM:
        y = _window_sum(x.to(torch.bfloat16).float(), size, -2)
        y = _window_sum(y.to(torch.bfloat16).float(), size, -1)
    elif size <= 7 and max(h, w) <= _BAND_MATMUL_MAX_DIM:
        y = _window_sum(_window_sum(x, size, -2), size, -1)
    else:
        y = _sliding_sum(_sliding_sum(x, size, -2), size, -1)
    if normalize:
        y = y / float(size * size)
    return y


def box_filter(img: torch.Tensor, size: int, normalize: bool = True) -> torch.Tensor:
    """Box filter of an image (H, W) or (H, W, C) over axes 0 and 1,
    replicate border (ops/filters.py::box_filter): (H, W) by window sums
    up to a 7-wide window and by edge-padded cumsum differences past it,
    (H, W, C) by ``box_filter_planes`` on the channel-leading planes, as
    the JAX function's branches run them."""
    if img.ndim == 2:
        if size <= 7:
            y = _window_sum(_window_sum(img, size, -2), size, -1)
        else:
            y = _sliding_sum(_sliding_sum(img, size, -2), size, -1)
        return y / float(size * size) if normalize else y
    planes = _image_as_planes(img, "box_filter", "box_filter_planes")
    return torch.movedim(box_filter_planes(planes, size, normalize), 0, -1)
