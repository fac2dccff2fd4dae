"""Global similarity pre-alignment for the burst pipelines (counterpart of
registration/prealign.py): estimate rotation / scale / translation per
alternate against frame 0 (registration/logpolar.py) -> one backward warp
into reference geometry plus a validity mask -> the tile pyramid sees
translation-only residuals.

Frames whose estimated rotation and scale are negligible pass through
untouched. The gate is a device-side select (torch.where), so nothing
goes back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from port_bench.reference.config import PREALIGN_FAST, RegistrationConfig
from port_bench.reference.ops.geometry import remap_planes
from port_bench.reference.ops.warp_fast import (
    default_warp_bound,
    similarity_warp_fast,
)
from port_bench.reference.registration.logpolar import (
    SimilarityTransform,
    register_rotation_scale_batched,
    register_similarity_batched,
)


def _box_down(gray: torch.Tensor, ds: int) -> torch.Tensor:
    """Box-mean downsample of (..., H, W) by an integer factor, cropped to
    a multiple of ``ds`` first (rows, then columns)."""
    if ds <= 1:
        return gray
    h, w = gray.shape[-2], gray.shape[-1]
    hh, hw = h // ds, w // ds
    rows = gray[..., : hh * ds, :].reshape(gray.shape[:-2] + (hh, ds, w)).mean(dim=-2)
    return rows[..., : hw * ds].reshape(rows.shape[:-1] + (hw, ds)).mean(dim=-1)


def estimate_burst_similarity(
    gray: torch.Tensor,
    cfg: RegistrationConfig = PREALIGN_FAST,
    with_translation: bool = True,
) -> SimilarityTransform:
    """Similarity of every alternate of gray (F, H, W) against frame 0,
    fields with a leading axis F - 1. ``cfg.downsample`` > 1 estimates on
    box-downsampled luma and scales the translation back; downsampling
    stops before the log-polar map would fall under 128 cells, and an
    image too small for the requested factor gets the full radial
    resolution (lp_radius_step 1) as well."""
    ds_req = max(int(cfg.downsample), 1)
    ds = ds_req
    h, w = gray.shape[-2], gray.shape[-1]
    while ds > 1 and max(h // ds, w // ds) < 128:
        ds //= 2
    if ds < ds_req and ds == 1 and cfg.lp_radius_step > 1:
        cfg = dataclasses.replace(cfg, lp_radius_step=1)
    if ds > 1:
        gray = _box_down(gray, ds)
    ref, moving = gray[0], gray[1:]
    if with_translation:
        st = register_similarity_batched(ref, moving, cfg)
        if ds > 1:
            st = dataclasses.replace(st, translation=st.translation * float(ds))
        return st
    rotation, scale, peak = register_rotation_scale_batched(ref, moving, cfg)
    return SimilarityTransform(
        rotation=rotation, scale=scale,
        translation=torch.zeros((moving.shape[0], 2), device=gray.device), response=peak,
    )


def _source_grid(
    h: int,
    w: int,
    st: SimilarityTransform,
    offset: Tuple[float, float] = (0.0, 0.0),
    origin=None,
    global_hw: Tuple[int, int] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward-warp source coordinates (B, h, w) per frame of ``st``,
    reconstructing the reference from the moved frame:
    ref(y) ~= moved(G(y - d)), G the unrotate / unscale map. ``offset``
    shifts the output grid (CFA plane sites at (+a/2, +b/2) half-res px)
    and is undone on the source side. ``origin`` / ``global_hw``: the
    (h, w) block is a window at ``origin`` of a ``global_hw`` image,
    rotated about the global center; the coordinates returned are local."""
    gh, gw = global_hw if global_hw is not None else (h, w)
    oy, ox = (0.0, 0.0) if origin is None else origin
    cy, cx = (gh - 1) / 2.0, (gw - 1) / 2.0
    dev = st.rotation.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] + offset[0]) + oy
    xs = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] + offset[1]) + ox
    yy = ys - st.translation[:, 0, None, None] - cy
    xx = xs - st.translation[:, 1, None, None] - cx
    ca = torch.cos(st.rotation)[:, None, None]
    sa = torch.sin(st.rotation)[:, None, None]
    sc = st.scale[:, None, None]
    src_y = (sa * xx + ca * yy) * sc + cy - offset[0] - oy
    src_x = (ca * xx - sa * yy) * sc + cx - offset[1] - ox
    return src_y, src_x


def similarity_is_significant(
    st: SimilarityTransform, rot_eps: float = 2e-3, scale_eps: float = 2e-3
) -> torch.Tensor:
    """Boolean per frame: rotation or scale far enough from identity that
    resampling beats keeping the original samples."""
    return (st.rotation.abs() > rot_eps) | ((st.scale - 1.0).abs() > scale_eps)


def _source_valid(src_y: torch.Tensor, src_x: torch.Tensor, h: int, w: int, fast: bool) -> torch.Tensor:
    """In-bounds mask of backward-warp source coordinates; for the fast
    warp also False where the shift exceeds the warp's clamp bound (the
    clamp misplaces content there)."""
    valid = (src_y >= 0.0) & (src_y <= h - 1.0) & (src_x >= 0.0) & (src_x <= w - 1.0)
    if fast:
        b = float(default_warp_bound(h, w))
        ys = torch.arange(h, dtype=torch.float32, device=src_y.device)[:, None]
        xs = torch.arange(w, dtype=torch.float32, device=src_y.device)[None, :]
        valid = valid & ((src_y - ys).abs() <= b) & ((src_x - xs).abs() <= b)
    return valid


def _warp(planes: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor, fast: bool, method: str):
    if fast:
        return similarity_warp_fast(planes, src_y, src_x)
    return remap_planes(planes, src_y, src_x, method)


def prewarp_frame(
    frame: torch.Tensor,
    st: SimilarityTransform,
    method: str = "bilinear",
    offset: Tuple[float, float] = (0.0, 0.0),
    fast: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp one (H, W) or (H, W, C) frame into reference geometry by the
    single similarity ``st`` (fields with a leading axis of 1). Returns
    (warped, valid (H, W))."""
    h, w = frame.shape[0], frame.shape[1]
    src_y, src_x = _source_grid(h, w, st, offset)
    planes = frame if frame.ndim == 2 else torch.movedim(frame, -1, 0)
    warped = _warp(planes, src_y[0], src_x[0], fast, method)
    if frame.ndim == 3:
        warped = torch.movedim(warped, 0, -1)
    return warped, _source_valid(src_y[0], src_x[0], h, w, fast).to(frame.dtype)


def _gated_valid(src_y, src_x, h, w, fast, use, dtype):
    valid = _source_valid(src_y, src_x, h, w, fast).to(dtype)
    keep = use.to(dtype)[:, None, None]
    return valid * keep + (1.0 - keep)


def apply_burst_similarity(
    burst: torch.Tensor,
    st: SimilarityTransform,
    cfg: RegistrationConfig = PREALIGN_FAST,
    method: str = "bilinear",
    origin=None,
    global_hw: Tuple[int, int] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp the alternates of ``burst`` (F, H, W[, C]) by ``st`` (leading
    axis F - 1). Returns (burst', valid (F, H, W)); frame 0 and
    near-identity frames pass through with valid 1."""
    h, w = burst.shape[1], burst.shape[2]
    use = similarity_is_significant(st)
    src_y, src_x = _source_grid(h, w, st, origin=origin, global_hw=global_hw)
    alts = burst[1:]
    if burst.ndim == 4:  # the channels share their frame's grid
        planes = alts.permute(0, 3, 1, 2)
        warped = _warp(planes, src_y[:, None], src_x[:, None], cfg.fast_warp, method).permute(0, 2, 3, 1)
    else:
        warped = _warp(alts, src_y, src_x, cfg.fast_warp, method)
    valid = _gated_valid(src_y, src_x, h, w, cfg.fast_warp, use, burst.dtype)
    warped = torch.where(use.reshape((-1,) + (1,) * (burst.ndim - 1)), warped, alts)
    ones = torch.ones((1, h, w), dtype=burst.dtype, device=burst.device)
    return torch.cat([burst[:1], warped], dim=0), torch.cat([ones, valid], dim=0)


def prealign_burst(
    burst: torch.Tensor,
    gray: torch.Tensor,
    cfg: RegistrationConfig = PREALIGN_FAST,
    method: str = "bilinear",
    with_translation: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-align an RGB or grayscale burst (F, H, W[, C]) against frame 0,
    estimated on its luma gray (F, H, W). Returns (burst', valid)."""
    st = estimate_burst_similarity(gray, cfg, with_translation)
    return apply_burst_similarity(burst, st, cfg, method)


def apply_planes_similarity(
    planes: torch.Tensor,
    st: SimilarityTransform,
    cfg: RegistrationConfig = PREALIGN_FAST,
    method: str = "bilinear",
    origin=None,
    global_hw: Tuple[int, int] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp the alternates of a CFA-plane burst (F, 2, 2, hh, hw) by
    ``st`` (leading axis F - 1), each plane with its own (+a/2, +b/2)
    half-res site offset, under the stricter 6e-3 gate. Returns
    (planes', valid (F, hh, hw)); origin / global_hw in half-res units."""
    use = similarity_is_significant(st, rot_eps=6e-3, scale_eps=6e-3)
    hh, hw = planes.shape[-2], planes.shape[-1]
    grids = [
        [_source_grid(hh, hw, st, (a / 2.0, b / 2.0), origin, global_hw) for b in (0, 1)]
        for a in (0, 1)
    ]
    gy = torch.stack([torch.stack([g[0] for g in row], 1) for row in grids], 1)  # (F-1, 2, 2, hh, hw)
    gx = torch.stack([torch.stack([g[1] for g in row], 1) for row in grids], 1)
    alts = planes[1:]
    warped = _warp(alts, gy, gx, cfg.fast_warp, method)
    warped = torch.where(use[:, None, None, None, None], warped, alts)
    # validity is coordinate math on the unshifted grid
    src_y, src_x = _source_grid(hh, hw, st, origin=origin, global_hw=global_hw)
    valid = _gated_valid(src_y, src_x, hh, hw, cfg.fast_warp, use, planes.dtype)
    ones = torch.ones((1, hh, hw), dtype=planes.dtype, device=planes.device)
    return torch.cat([planes[:1], warped], dim=0), torch.cat([ones, valid], dim=0)


def prealign_planes(
    planes: torch.Tensor,
    gray_half: torch.Tensor,
    cfg: RegistrationConfig = PREALIGN_FAST,
    method: str = "bilinear",
    with_translation: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-align a CFA-plane burst (F, 2, 2, hh, hw), estimated on its
    half-res luma (F, hh, hw). Returns (planes', valid (F, hh, hw))."""
    st = estimate_burst_similarity(gray_half, cfg, with_translation)
    return apply_planes_similarity(planes, st, cfg, method)
