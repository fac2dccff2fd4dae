"""Dense Lucas-Kanade refinement (counterpart of
registration/lucas_kanade.py), batched over leading axes: a reference
broadcasts against the moving frames."""

from __future__ import annotations

import torch

from port_bench.reference.config import LKConfig
from port_bench.reference.ops.derivatives import (
    derivatives_pair_planes,
    derivatives_planes,
)
from port_bench.reference.ops.filters import box_filter_planes
from port_bench.reference.ops.geometry import warp_backward_planes
from port_bench.reference.ops.warp_fast import (
    decompose_flow,
    tile_bounded_taps,
    warp_bounded_planes,
    warp_taps,
)


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
        ix, iy, it = derivatives_pair_planes(ref, warped)
    else:
        rdx, rdy = ref_derivs
        wdx, wdy = derivatives_planes(warped)
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
    cfg: LKConfig = LKConfig(),
) -> torch.Tensor:
    """Refine flows so that moved(x + flow(x)) ~= ref(x). ref (..., H, W)
    broadcasts against moved (..., H, W); flow0 (..., H, W, 2) as (dy, dx).

    The warp of each iteration is chosen as in the JAX function:
    ``cfg.warp_tile > 0``: the flow re-decomposed into per-tile integer
    shifts (``tile_warp_select``, clipped at +-16) and a residual clamped
    to max(bounded_warp, 2) px (``warp_bounded``), applied as the one set
    of gather taps that ``tile_bounded_taps`` composes; else
    ``cfg.bounded_warp > 0``: the bounded-residual warp alone; else the
    bilinear gather warp ``warp_backward``."""
    if cfg.warp_tile > 0:
        rb = max(cfg.bounded_warp, 2)

        def warp(img, fl):
            tile_int, res = decompose_flow(fl, cfg.warp_tile)
            h, w = img.shape[-2], img.shape[-1]
            return warp_taps(img, tile_bounded_taps(tile_int, res.clamp(-rb, rb), cfg.warp_tile, rb, h, w))

    elif cfg.bounded_warp > 0:

        def warp(img, fl):
            return warp_bounded_planes(img, fl, cfg.bounded_warp)

    else:
        warp = warp_backward_planes
    ref_derivs = derivatives_planes(ref)  # constant across iterations
    flow = flow0
    for _ in range(cfg.iterations):
        flow = flow + lk_step(ref, warp(moved, flow), cfg, ref_derivs)
    return flow
