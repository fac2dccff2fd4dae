"""Configuration: the JAX package's frozen dataclasses, re-exported.

``multi_frame_super_resolution_tpu.config`` imports only dataclasses and
typing, and that package's ``__init__`` imports only ``config``, so the
port reads the very same objects without importing jax. Both sides of a
parity test therefore see identical settings.

``check_supported`` (RGB path) and ``check_supported_raw`` (RAW path)
name every knob whose code path the port does not implement yet and
raise instead of silently computing something else (the rule of the JAX
code at models/handheld.py:411-420).
"""

from __future__ import annotations

from typing import List

from multi_frame_super_resolution_tpu.config import (  # noqa: F401
    PREALIGN_FAST,
    AlignConfig,
    DarkChannelConfig,
    HandheldConfig,
    LKConfig,
    MergeConfig,
    PolarDefogConfig,
    RegistrationConfig,
    RobustnessConfig,
)

# the RGB fast path through the merge kernel without global pre-alignment
PORT_DEFAULT = HandheldConfig(prealign=False, merge=MergeConfig(use_pallas=True))

# the RAW main path (bench.py's configuration) without global
# pre-alignment: fast path, LK, order-1 merge with the plugin solver and
# the certless centroid, gated restore, scale 2
RAW_PORT_DEFAULT = HandheldConfig(
    align=AlignConfig(tile_size=16, search_radius=4, levels=2),
    gamma=False,
    prealign=False,
)


# bench.py's configuration, letter for letter: the RAW main path with
# global pre-alignment
RAW_BENCH = HandheldConfig(align=AlignConfig(tile_size=16, search_radius=4, levels=2), gamma=False)

# the RGB fast path through the merge kernel, with global pre-alignment
RGB_PALLAS = HandheldConfig(merge=MergeConfig(use_pallas=True))

_REMAP_METHODS = ("bilinear", "bicubic", "nearest")


def _common_unsupported(cfg: HandheldConfig) -> List[str]:
    bad = []
    if cfg.prealign and cfg.prealign_cfg.logpolar_interp not in _REMAP_METHODS:
        bad.append(f"prealign_cfg.logpolar_interp={cfg.prealign_cfg.logpolar_interp!r}")
    if not cfg.fast:
        bad.append("fast=False")
    if cfg.use_consistency:
        bad.append("use_consistency=True")
    if not cfg.warp_matmul:
        # the one-hot tile_warp_select computes another function at bound 16
        bad.append("warp_matmul=False")
    if cfg.align.use_fft:
        bad.append("align.use_fft=True")
    if cfg.lk.warp_tile > 0:
        bad.append("lk.warp_tile>0")
    return bad


def _raise(bad: List[str], start: str) -> None:
    if bad:
        raise ValueError(
            "not implemented by the PyTorch port: " + ", ".join(bad)
            + f"; start from {start}"
        )


def check_supported(cfg: HandheldConfig) -> None:
    """Raise ``ValueError`` naming each knob of ``cfg`` that selects an RGB
    path the port does not implement."""
    bad = _common_unsupported(cfg)
    if cfg.rgb_half_stats:
        bad.append("rgb_half_stats=True")
    if not cfg.merge.use_pallas:
        bad.append("merge.use_pallas=False")
    rgb_order = cfg.merge.order if cfg.merge.rgb_order is None else cfg.merge.rgb_order
    if rgb_order == 1:
        bad.append("merge.rgb_order=1")
    if not 1 <= cfg.scale <= 4:
        bad.append(f"scale={cfg.scale} (the merge kernel takes 1..4)")
    _raise(bad, "config.RGB_PALLAS")


def check_supported_raw(cfg: HandheldConfig) -> None:
    """Raise ``ValueError`` naming each knob of ``cfg`` that selects a RAW
    path the port does not implement."""
    bad = _common_unsupported(cfg)
    m = cfg.merge
    if m.order == 0:
        bad.append("merge.order=0")
    if m.solver == "exact":
        bad.append("merge.solver='exact'")
    if m.centroid_cert:
        bad.append("merge.centroid_cert=True")
    if m.exact_weights:
        bad.append("merge.exact_weights=True")
    if m.guided_rb:
        bad.append("merge.guided_rb=True")
    if cfg.scale != 2:
        # the RAW merge kernel holds its accumulators in registers for s=2
        bad.append(f"scale={cfg.scale} (the RAW merge kernel takes 2)")
    _raise(bad, "config.RAW_BENCH")
