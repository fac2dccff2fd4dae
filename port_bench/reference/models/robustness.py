"""Merge robustness (certainty) model (counterpart of models/robustness.py):
local 3x3 statistics of the reference against the flow-shifted moving
frames under the noise model sigma_md = sqrt(alpha * mean + beta), gated
by the local 5x5 flow spread. The fast paths shift by a bounded warp of
the rounded (small) flow; the gather (oracle) paths, ``bounded=0``, by a
per-pixel clamped gather at the rounded flow."""

from __future__ import annotations

import math

import torch

from port_bench.reference.config import RobustnessConfig
from port_bench.reference.ops.filters import _const, box_filter_planes
from port_bench.reference.ops.morphology import dilate_planes, erode_planes
from port_bench.reference.ops.warp_fast import _gather_flat, warp_bounded_planes


def _gather_shifted(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Planes (..., C, H, W) sampled at x + shift, shift (..., H, W, 2) a
    per-pixel integer shift broadcast over C, clamped borders."""
    h, w = img.shape[-2], img.shape[-1]
    dev = img.device
    ys = (torch.arange(h, device=dev)[:, None] + shift[..., 0].long()).clamp_(0, h - 1)
    xs = (torch.arange(w, device=dev) + shift[..., 1].long()).clamp_(0, w - 1)
    return _gather_flat(img, (ys * w + xs).unsqueeze(-3))


def _box3(img: torch.Tensor) -> torch.Tensor:
    """3 x 3 normalized box filter of channel-last images (..., H, W, C)."""
    return torch.movedim(box_filter_planes(torch.movedim(img, -1, -3), 3, normalize=True), -3, -1)


def robustness_mask(
    ref: torch.Tensor,
    moved: torch.Tensor,
    flow: torch.Tensor,
    cfg: RobustnessConfig = RobustnessConfig(),
    bounded: int = 0,
) -> torch.Tensor:
    """Certainty masks for alternate frames.

    ref (H, W, 3); moved (..., H, W, 3); flow (..., H, W, 2), small
    (already tile-compensated) for ``bounded`` > 0, any size with
    ``bounded=0`` (the gather). Returns (..., H, W, 4): RGB certainties in
    [0, 1] and the motion-inconsistency metric M in the last channel.
    """
    mean_ref = _box3(ref)
    mean_sq_ref = _box3(ref * ref)
    std_ref = torch.sqrt((mean_sq_ref - mean_ref * mean_ref).clamp_min(0.0))

    moved_planes = box_filter_planes(torch.movedim(moved, -1, -3), 3, normalize=True)
    if bounded > 0:
        mean_moved_planes = warp_bounded_planes(moved_planes, torch.round(flow).unsqueeze(-4), bounded)
    else:
        mean_moved_planes = _gather_shifted(moved_planes, torch.round(flow))
    mean_moved = torch.movedim(mean_moved_planes, -3, -1)

    # local 5x5 flow spread, scaled by the local mean distance
    flow_max = torch.stack([dilate_planes(flow[..., 0], 5), dilate_planes(flow[..., 1], 5)], -1)
    flow_min = torch.stack([erode_planes(flow[..., 0], 5), erode_planes(flow[..., 1], 5)], -1)
    mean_dist = (mean_ref - mean_moved).abs().mean(dim=-1)
    spread = (flow_max - flow_min) * (0.5 * mean_dist)[..., None]
    m = torch.sqrt((spread * spread).sum(dim=-1))

    sigma_md = torch.sqrt(cfg.alpha * mean_ref + cfg.beta)
    # two green samples averaged per Bayer quad -> /sqrt(2)
    sigma_md = sigma_md * _const((1.0, 1.0 / math.sqrt(2.0), 1.0), ref.device)

    dist = (mean_ref - mean_moved).abs()
    var_ref = std_ref * std_ref
    dist = dist * (var_ref / (var_ref + sigma_md * sigma_md))
    sigma = torch.maximum(sigma_md, std_ref)

    s = torch.where(m > cfg.threshold_m, 0.0, cfg.s)[..., None]
    mask = (s * torch.exp(-(dist * dist) / (sigma * sigma)) - cfg.t).clamp(0.0, 1.0)
    return torch.cat([mask, m[..., None]], dim=-1)
