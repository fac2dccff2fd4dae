"""Dense optical flow backend factory (counterpart of
registration/optical_flow.py): the createOptFlow selector surface,
farneback | tvl1 | brox | pyrlk, each a function (ref, moved) -> flows
(..., H, W, 2) with moved(x + flow(x)) ~= ref(x). ref (..., H, W)
broadcasts against moved (..., H, W), so the alternates of a window, and
every window of a video, go through one call."""

from __future__ import annotations

from typing import Callable

import torch

from multi_frame_super_resolution_tpu_torch.config import FlowConfig
from multi_frame_super_resolution_tpu_torch.registration.brox import brox_flow
from multi_frame_super_resolution_tpu_torch.registration.farneback import farneback_flow
from multi_frame_super_resolution_tpu_torch.registration.lucas_kanade import pyrlk_flow
from multi_frame_super_resolution_tpu_torch.registration.tvl1 import tvl1_flow

FlowFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_BACKENDS = {
    "pyrlk": pyrlk_flow,
    "farneback": farneback_flow,
    "tvl1": tvl1_flow,
    "brox": brox_flow,
}


def create_optical_flow(cfg: FlowConfig = FlowConfig()) -> FlowFn:
    if cfg.method not in _BACKENDS:
        raise ValueError(f"unknown optical flow {cfg.method!r}; expected one of {sorted(_BACKENDS)}")
    backend = _BACKENDS[cfg.method]
    return lambda ref, moved: backend(ref, moved, cfg)


def available_backends():
    return sorted(_BACKENDS)
