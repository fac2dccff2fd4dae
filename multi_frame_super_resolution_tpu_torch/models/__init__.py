"""Pipelines and merge models (counterparts of
multi_frame_super_resolution_tpu.models).

The names the JAX package re-exports here resolve at first access
(PEP 562), so that a kernel wrapper, which imports a model module, and
this package can import each other in either order. No kernel builds on
import: each builds at first use."""

import importlib

# name -> the module of this package that defines it
_EXPORTS = {
    "handheld_superres": "handheld",
    "handheld_superres_raw": "handheld",
    "apply_weighting": "merge",
    "kernel_params": "merge",
    "merge_burst_raw": "merge",
    "merge_burst_rgb": "merge",
    "smoothed_structure_tensor": "merge",
    "btvl1_superres": "btvl1",
    "btvl1_video": "btvl1",
    "dark_channel": "defog",
    "dark_channel_defog": "defog",
    "polar_defog": "defog",
    "stokes_synthesis": "defog",
    "robustness_mask": "robustness",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
