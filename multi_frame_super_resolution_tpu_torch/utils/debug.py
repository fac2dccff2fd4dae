"""Debug and failure-detection utilities (counterpart of utils/debug.py):
npz dumps of intermediate buffers, a host-side finiteness report, and the
NaN guard of the kernels' own policy (NaN -> 0) with a scoped switch that
turns it into a trap.

PyTorch has no global NaN trap like ``jax_debug_nans``, which makes every
jitted op check its output. ``debug_nans`` is the nearest counterpart:
under it, ``guard_finite`` raises on a non-finite value instead of
scrubbing it, so the trap fires at the guards a pipeline places, not at
the op that made the value. ``torch.autograd.set_detect_anomaly`` covers
the backward pass.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict

import numpy as np
import torch

_DEBUG_NANS = contextvars.ContextVar("mfsr_debug_nans", default=False)


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dump_intermediates(path: str, **arrays: Any) -> str:
    """Save named intermediate arrays (tensors on any device, or numpy) to
    an .npz for offline comparison."""
    np.savez(path, **{k: _numpy(v) for k, v in arrays.items()})
    return path


def check_finite(name: str, x: Any) -> Dict[str, float]:
    """Host-side finiteness/stat report for an array."""
    arr = _numpy(x)
    return {
        "name": name,
        "finite_frac": float(np.isfinite(arr).mean()),
        "min": float(np.nanmin(arr)),
        "max": float(np.nanmax(arr)),
        "mean": float(np.nanmean(arr)),
    }


def guard_finite(x: torch.Tensor, name: str = "array") -> torch.Tensor:
    """NaNs scrubbed to 0 (and infinities to the largest finite values),
    the kernels' own NaN policy; under ``debug_nans`` it raises
    FloatingPointError on a non-finite value instead (a host readback)."""
    if _DEBUG_NANS.get() and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"{name}: non-finite value under debug_nans")
    return torch.nan_to_num(x, nan=0.0)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the scope, ``guard_finite`` raises on a non-finite value
    (``enable=True``) or scrubs it (``enable=False``)."""
    token = _DEBUG_NANS.set(enable)
    try:
        yield
    finally:
        _DEBUG_NANS.reset(token)
