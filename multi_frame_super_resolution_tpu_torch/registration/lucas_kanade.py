"""Dense Lucas-Kanade refinement (counterpart of
registration/lucas_kanade.py) on the bounded-residual warp path, batched
over a leading frame axis."""

from __future__ import annotations

import torch

from multi_frame_super_resolution_tpu_torch.config import LKConfig
from multi_frame_super_resolution_tpu_torch.ops.derivatives import (
    derivatives,
    derivatives_pair,
)
from multi_frame_super_resolution_tpu_torch.ops.filters import box_filter_planes
from multi_frame_super_resolution_tpu_torch.ops.warp_fast import warp_bounded


def lk_step(
    ref: torch.Tensor,
    warped: torch.Tensor,
    cfg: LKConfig,
    ref_derivs=None,
) -> torch.Tensor:
    """One LK increment (..., H, W, 2) from the reference (H, W) and the
    current warped frames (..., H, W). ``ref_derivs`` (dx, dy of ref) may
    be computed once outside the iteration loop."""
    if ref_derivs is None:
        ix, iy, it = derivatives_pair(ref, warped)
    else:
        rdx, rdy = ref_derivs
        wdx, wdy = derivatives(warped)
        ix = 0.5 * (rdx + wdx)
        iy = 0.5 * (rdy + wdy)
        it = ref - warped
    win = 2 * cfg.half_window + 1

    prods = torch.stack([ix * ix, ix * iy, iy * iy, ix * it, iy * it], dim=-3)
    sums = box_filter_planes(prods, win, normalize=False, mxu_bf16=cfg.bf16)
    sxx, sxy, syy, sxt, syt = sums.unbind(dim=-3)

    # eigenvalues of the symmetric PSD normal matrix = its singular values
    tr = sxx + syy
    disc = torch.sqrt((sxx - syy) ** 2 + 4.0 * sxy * sxy)
    lam_min = 0.5 * (tr - disc)
    ok = lam_min > cfg.min_sigma

    det = sxx * syy - sxy * sxy
    safe_det = torch.where(det.abs() > 1e-12, det, 1.0)
    dx = (syy * sxt - sxy * syt) / safe_det
    dy = (sxx * syt - sxy * sxt) / safe_det
    valid = ok & (det.abs() > 1e-12)
    dx = torch.where(valid, dx, 0.0)
    dy = torch.where(valid, dy, 0.0)
    return torch.nan_to_num(torch.stack([dy, dx], dim=-1), nan=0.0)


def lk_refine(
    ref: torch.Tensor,
    moved: torch.Tensor,
    flow0: torch.Tensor,
    cfg: LKConfig = LKConfig(bounded_warp=2),
) -> torch.Tensor:
    """Refine flows so that moved(x + flow(x)) ~= ref(x). ref (H, W);
    moved (..., H, W); flow0 (..., H, W, 2) as (dy, dx). Implements the
    bounded-residual warp (``cfg.bounded_warp > 0``), the path the fast
    pipelines take."""
    if cfg.warp_tile > 0 or cfg.bounded_warp <= 0:
        raise ValueError(
            "the port implements only the bounded-residual LK warp "
            "(bounded_warp > 0, warp_tile == 0)"
        )
    ref_derivs = derivatives(ref)  # constant across iterations
    flow = flow0
    for _ in range(cfg.iterations):
        warped = warp_bounded(moved, flow, cfg.bounded_warp)
        flow = flow + lk_step(ref, warped, cfg, ref_derivs)
    return flow
