"""Configuration: the JAX package's frozen dataclasses, re-exported.

``multi_frame_super_resolution_tpu.config`` imports only dataclasses and
typing, and that package's ``__init__`` imports only ``config``, so the
port reads the very same objects without importing jax. Both sides of a
parity test therefore see identical settings.

``check_supported`` names every knob whose code path the port does not
implement yet and raises instead of silently computing something else
(the rule of the JAX code at models/handheld.py:411-420).
"""

from __future__ import annotations

from multi_frame_super_resolution_tpu.config import (  # noqa: F401
    AlignConfig,
    HandheldConfig,
    LKConfig,
    MergeConfig,
    RobustnessConfig,
)

# the configuration the port implements end to end: the RGB fast path
# through the merge kernel, without global pre-alignment
PORT_DEFAULT = HandheldConfig(prealign=False, merge=MergeConfig(use_pallas=True))


def check_supported(cfg: HandheldConfig) -> None:
    """Raise ``ValueError`` naming each knob of ``cfg`` that selects a path
    the port does not implement."""
    bad = []
    if cfg.prealign:
        bad.append("prealign=True")
    if not cfg.fast:
        bad.append("fast=False")
    if cfg.use_consistency:
        bad.append("use_consistency=True")
    if cfg.rgb_half_stats:
        bad.append("rgb_half_stats=True")
    if not cfg.warp_matmul:
        bad.append("warp_matmul=False")
    if not cfg.merge.use_pallas:
        bad.append("merge.use_pallas=False")
    rgb_order = cfg.merge.order if cfg.merge.rgb_order is None else cfg.merge.rgb_order
    if rgb_order == 1:
        bad.append("merge.rgb_order=1")
    if cfg.align.use_fft:
        bad.append("align.use_fft=True")
    if not cfg.align.fast_extract:
        bad.append("align.fast_extract=False")
    radii = [cfg.align.search_radius]
    if cfg.align.fine_radius is not None:
        radii.append(cfg.align.fine_radius)
    if 2 * max(radii) > cfg.align.tile_size:
        # align_frames then leaves the fused fast branch (align.py:80-84)
        bad.append("align search radius > tile_size/2")
    if cfg.lk.warp_tile > 0:
        bad.append("lk.warp_tile>0")
    if not 1 <= cfg.scale <= 4:
        bad.append(f"scale={cfg.scale} (the merge kernel takes 1..4)")
    if bad:
        raise ValueError(
            "not implemented by the PyTorch port: " + ", ".join(bad)
            + "; start from HandheldConfig(prealign=False, "
            "merge=MergeConfig(use_pallas=True))"
        )
