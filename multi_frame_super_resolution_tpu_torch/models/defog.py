"""Image defogging: dark-channel prior and polarization difference
(counterpart of models/defog.py).

The airlight is chosen on the device: the top-k pixels of the dark
channel by ``ops.reduce.top_k_indices`` (``lax.top_k``'s tie order), and
P and A_inf stay tensors on the device, so a frame runs with no host
round trip. The per-pixel stage of ``polar_defog`` goes through the defog
kernel's wrapper (the Hopper kernel on CUDA tensors, its plain version
``defog_pixels`` on CPU tensors).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function

from multi_frame_super_resolution_tpu_torch.config import DarkChannelConfig, PolarDefogConfig
from multi_frame_super_resolution_tpu_torch.kernels.defog import defog
from multi_frame_super_resolution_tpu_torch.ops.color import normalize_minmax
from multi_frame_super_resolution_tpu_torch.ops.morphology import erode_planes, min_channels
from multi_frame_super_resolution_tpu_torch.ops.reduce import top_k_indices


def dark_channel(img: torch.Tensor, window: int) -> torch.Tensor:
    """Dark channel of (H, W, C): per-pixel channel min, then a window x
    window min filter."""
    return erode_planes(min_channels(img), window)


def dark_channel_defog(
    img: torch.Tensor, cfg: DarkChannelConfig = DarkChannelConfig()
) -> torch.Tensor:
    """He et al. dark-channel-prior dehazing of (H, W, C): airlight = per-
    channel max over the brightest top_percent dark-channel pixels;
    transmission from the dark channel of I / A; J = (I - A) / max(t, t0) + A."""
    h, w = img.shape[:2]
    dark = dark_channel(img, cfg.window)
    k = max(int(cfg.top_percent * h * w), 1)
    airlight = img.reshape(h * w, -1)[top_k_indices(dark, k)].amax(dim=0)
    norm = img / airlight.clamp_min(1e-6)
    dark_a = dark_channel(norm, cfg.window)
    t = (1.0 - cfg.omega * dark_a).clamp_min(cfg.t0)[..., None]
    return (img - airlight) / t + airlight


def stokes_synthesis(
    i0: torch.Tensor, i45: torch.Tensor, i90: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Iper, Ipar), each (H, W, 3), from 0/45/90-degree polarization
    frames (H, W): I135 = I0 + I90 - I45, Stokes S0/S1/S2, degree of
    polarization D, Iper/Ipar = (1 +- D) S0 / 2, each min-max normalized
    and replicated to 3 channels."""
    i135 = i0 + i90 - i45
    s0 = i0 + i90
    s1 = i0 - i90
    s2 = i45 - i135
    d = torch.sqrt(s1 * s1 + s2 * s2) / (s0 + 1e-15)
    iper = normalize_minmax((1.0 + d) * s0 / 2.0)
    ipar = normalize_minmax((1.0 - d) * s0 / 2.0)
    shape = tuple(iper.shape) + (3,)
    return iper[..., None].expand(shape).contiguous(), ipar[..., None].expand(shape).contiguous()


def polar_defog(
    iper: torch.Tensor,
    ipar: torch.Tensor,
    cfg: PolarDefogConfig = PolarDefogConfig(),
    return_intermediates: bool = False,
):
    """Polarization-difference defogging of an (Iper, Ipar) pair, both
    (H, W, 3) float32 in [0, 1]: dark prior of Iper (25 x 25 erode at
    radius 12); airlight sums over the top ``percent`` dark pixels;
    P = beta (SumPer - SumPar) / (SumPer + SumPar), A_inf =
    (SumPer + SumPar) / k; then per pixel A, t and R (kernels/defog.py).
    Returns R, or (R, A, t) with ``return_intermediates``."""
    # the record_function ranges name the stages in a profiler trace
    h, w = iper.shape[:2]
    with record_function("mfsr.defog.dark_channel"):
        dark = dark_channel(iper, 2 * cfg.radius + 1)
    with record_function("mfsr.defog.airlight"):
        k = max(int(cfg.percent * h * w), 1)
        idx = top_k_indices(dark, k)
        sum_per = iper.reshape(h * w, 3)[idx].sum(dim=0)
        sum_par = ipar.reshape(h * w, 3)[idx].sum(dim=0)
        p = cfg.beta * (sum_per - sum_par) / (sum_per + sum_par)
        ainfi = (sum_per + sum_par) / k
    with record_function("mfsr.defog.pixels"):
        a, t, r = defog(
            iper.contiguous(), ipar.contiguous(), p, ainfi,
            cfg.t_min, cfg.t_max, cfg.r_min, cfg.r_max,
        )
    if return_intermediates:
        return r, a, t
    return r
