"""Linear filters with the replicate border: separable correlation and box
filters (counterparts of ops/filters.py).

The JAX package lowers these to banded matmuls for the TPU's matrix unit;
here each 1-D pass is a window sum over an edge-padded axis, which is the
same function (the band matrix bakes the replicate border in exactly as
edge padding does). Only the order of the f32 additions differs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# above this edge length the JAX package leaves the banded-matmul forms
# (ops/filters.py:_BAND_MATMUL_MAX_DIM); the bf16 box path follows it
_BAND_MATMUL_MAX_DIM = 1024


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small constant on ``device``, copied there once per process: a
    copy from pageable host memory would stall the host until the card
    has drained its queue, on every call."""
    return torch.tensor(values, dtype=dtype, device=device)


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


def _windows(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Edge-padded sliding windows of ``size`` taps at offsets
    -size//2 .. size-1-size//2 along ``axis``, as a trailing dim."""
    axis = axis % x.ndim
    r = size // 2
    return _pad_edge(x, axis, r, size - 1 - r).unfold(axis, size, 1)


def _filter_axis(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """1-D correlation out[i] = sum_t taps[t] * x[clamp(i + t - r)] along
    ``axis`` (the band matrix of ops/filters.py::_band_matrix)."""
    t = _const(tuple(np.asarray(taps, np.float32).reshape(-1).tolist()), x.device)
    return (_windows(x, t.numel(), axis) * t).sum(-1)


def separable_filter(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable correlation of the LAST TWO axes (rows, then columns),
    replicate border."""
    return _filter_axis(_filter_axis(img, ky, -2), kx, -1)


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
    """Box filter of a channel-last image (..., H, W, C): the channel-minor
    branch of ops/filters.py::box_filter, which runs box_filter_planes on
    the channel-leading planes."""
    planes = torch.movedim(img, -1, -3)
    return torch.movedim(box_filter_planes(planes, size, normalize), -3, -1)
