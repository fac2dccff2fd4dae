"""Merge robustness (certainty) model (counterpart of models/robustness.py)
on the bounded fast path: local 3x3 statistics of the reference against
the flow-shifted moving frames under the noise model
sigma_md = sqrt(alpha * mean + beta), gated by the local 5x5 flow spread."""

from __future__ import annotations

import math

import torch

from multi_frame_super_resolution_tpu_torch.config import RobustnessConfig
from multi_frame_super_resolution_tpu_torch.ops.filters import _const, box_filter
from multi_frame_super_resolution_tpu_torch.ops.morphology import dilate, erode
from multi_frame_super_resolution_tpu_torch.ops.warp_fast import warp_bounded


def robustness_mask(
    ref: torch.Tensor,
    moved: torch.Tensor,
    flow: torch.Tensor,
    cfg: RobustnessConfig = RobustnessConfig(),
    bounded: int = 2,
) -> torch.Tensor:
    """Certainty masks for alternate frames.

    ref (H, W, 3); moved (..., H, W, 3); flow (..., H, W, 2), small
    (already tile-compensated). Returns (..., H, W, 4): RGB certainties in
    [0, 1] and the motion-inconsistency metric M in the last channel.
    """
    if bounded <= 0:
        raise ValueError("the port implements only the bounded (gatherless) path")
    mean_ref = box_filter(ref, 3, normalize=True)
    mean_sq_ref = box_filter(ref * ref, 3, normalize=True)
    std_ref = torch.sqrt((mean_sq_ref - mean_ref * mean_ref).clamp_min(0.0))

    mean_moved_planes = warp_bounded(
        torch.movedim(box_filter(moved, 3, normalize=True), -1, -3),
        torch.round(flow).unsqueeze(-4),
        bounded,
    )
    mean_moved = torch.movedim(mean_moved_planes, -3, -1)

    # local 5x5 flow spread, scaled by the local mean distance
    flow_max = torch.stack([dilate(flow[..., 0], 5), dilate(flow[..., 1], 5)], -1)
    flow_min = torch.stack([erode(flow[..., 0], 5), erode(flow[..., 1], 5)], -1)
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
