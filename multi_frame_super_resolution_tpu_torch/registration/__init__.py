"""Burst registration (counterparts of
multi_frame_super_resolution_tpu.registration).

The names the JAX package re-exports here resolve at first access
(PEP 562), so that the tile-search wrapper, which imports
``registration.tiles``, and this package can import each other in either
order."""

import importlib

# name -> the module of this package that defines it
_EXPORTS = {
    "align_burst": "align",
    "align_pair": "align",
    "build_pyramid": "align",
    "flow_from_tile_shifts": "align",
    "design_matrix": "global_shift",
    "measurement_pairs": "global_shift",
    "shifts_to_reference": "global_shift",
    "solve_consistent_shifts": "global_shift",
    "SimilarityTransform": "logpolar",
    "log_polar_maps": "logpolar",
    "log_polar_params": "logpolar",
    "register_rotation_scale": "logpolar",
    "register_similarity": "logpolar",
    "register_translation": "logpolar",
    "to_log_polar": "logpolar",
    "farneback_flow": "farneback",
    "poly_expansion": "farneback",
    "lk_refine": "lucas_kanade",
    "lk_step": "lucas_kanade",
    "pyrlk_flow": "lucas_kanade",
    "available_backends": "optical_flow",
    "create_optical_flow": "optical_flow",
    "brox_flow": "brox",
    "tvl1_flow": "tvl1",
    "correlation_surface": "phase_correlation",
    "phase_correlate": "phase_correlation",
    "quadratic_subpixel_max": "subpixel",
    "quadratic_subpixel_min": "subpixel",
    "extract_ref_tiles": "tiles",
    "extract_search_windows": "tiles",
    "find_min_shift": "tiles",
    "ssd_surface": "tiles",
    "tile_counts": "tiles",
    "upsample_shift_field": "tiles",
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
