"""End-to-end handheld multi-frame super-resolution, RGB burst in (counterpart
of models/handheld.py::handheld_superres -> _handheld_fast on the merge
kernel's branch, handheld.py:235-426).

Pipeline: half-res tile-pyramid alignment -> per-tile integer warp of
the alternates -> smooth subpixel residual + Lucas-Kanade refinement ->
robustness on the warped frames -> structure-tensor kernel parameters
-> static-tap merge (the Hopper kernel on CUDA) -> weight-threshold
normalization against a bicubic fallback. Everything runs on the device
of the input burst.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from multi_frame_super_resolution_tpu_torch.config import (
    PORT_DEFAULT,
    HandheldConfig,
    MergeConfig,
    check_supported,
)
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast
from multi_frame_super_resolution_tpu_torch.models.merge import (
    apply_weighting,
    kernel_params,
    smoothed_structure_tensor,
)
from multi_frame_super_resolution_tpu_torch.models.robustness import robustness_mask
from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray, srgb_gamma
from multi_frame_super_resolution_tpu_torch.ops.geometry import downsample2
from multi_frame_super_resolution_tpu_torch.ops.warp_fast import (
    _repeat_tiles,
    tile_shift_decompose,
    tile_warp_matmul,
    upsample_int,
)
from multi_frame_super_resolution_tpu_torch.registration.align import (
    align_burst,
    flow_from_tile_shifts,
)
from multi_frame_super_resolution_tpu_torch.registration.lucas_kanade import lk_refine


def _scaled_merge_cfg(cfg: HandheldConfig) -> MergeConfig:
    """Merge config with the kernel variance clamps rescaled to the output
    grid by (scale/2)^2, so their input-pixel footprint stays constant."""
    m = (cfg.scale / 2.0) ** 2
    if m == 1.0:
        return cfg.merge
    return dataclasses.replace(
        cfg.merge,
        k_min=cfg.merge.k_min * m,
        k_max=cfg.merge.k_max * m,
        k_min_rb=cfg.merge.k_min_rb * m,
    )


def handheld_superres(
    burst: torch.Tensor, cfg: HandheldConfig = PORT_DEFAULT
) -> torch.Tensor:
    """RGB burst (F, H, W, 3) float32, frame 0 the reference ->
    merged (scale*H, scale*W, 3) in [0, 1]. Raises ValueError for config
    knobs the port does not implement (config.check_supported)."""
    check_supported(cfg)
    if burst.ndim != 4 or burst.shape[-1] != 3 or burst.shape[0] < 2:
        raise ValueError(f"burst must be (F>=2, H, W, 3), got {tuple(burst.shape)}")
    if burst.dtype != torch.float32:
        raise TypeError(f"burst must be float32, got {burst.dtype}")
    return _handheld_fast(burst.contiguous(), cfg)


def _handheld_fast(burst: torch.Tensor, cfg: HandheldConfig) -> torch.Tensor:
    # the record_function ranges name the stages in a profiler trace
    f, h, w = burst.shape[:3]
    t = cfg.align.tile_size
    gray = rgb_to_gray(burst)
    # motion is estimated on half-res luma and lifted to full res; the
    # merge still sees full-res samples
    half = cfg.half_align and h % 2 == 0 and w % 2 == 0
    with record_function("mfsr.align"):
        if half:
            gray_est = downsample2(gray)
            warp_t = 2 * t  # the half-res tile grid covers 2t full-res px
        else:
            gray_est = gray
            warp_t = t
        tile_shifts = align_burst(gray_est, cfg.align)
        if half:
            tile_shifts = tile_shifts * 2.0
        int_shifts, res_tiles = tile_shift_decompose(tile_shifts)

    # integer tile warp of the alternates' channel planes into reference
    # geometry (the function of tile_warp_matmul)
    with record_function("mfsr.tile_warp"):
        planes = burst[1:].permute(0, 3, 1, 2)  # (f-1, 3, h, w)
        warped_alts = tile_warp_matmul(planes, int_shifts[1:], warp_t).permute(0, 2, 3, 1)
        warped = torch.cat([burst[:1], warped_alts], dim=0).contiguous()

    def lift(res):  # (..., nty, ntx, 2) -> (..., h, w, 2)
        return _repeat_tiles(res, warp_t, h, w)

    # residual = smooth dense flow minus the block-constant integer warp
    if cfg.smooth_residual:
        smooth_flow = flow_from_tile_shifts(tile_shifts, warp_t, h, w)
        res_flow = smooth_flow - lift(int_shifts.float())
    else:
        res_flow = lift(res_tiles)

    # LK and robustness of the reference frame are overwritten (zero flow,
    # certainty 1), so only the alternates are computed
    res_alts = res_flow[1:]
    if cfg.use_lk:
        with record_function("mfsr.lk"):
            gray_w = rgb_to_gray(warped)
            lk_cfg = dataclasses.replace(
                cfg.lk, bounded_warp=max(int(cfg.residual_bound) + 1, 2)
            )
            res_alts = lk_refine(gray_w[0], gray_w[1:], res_alts, lk_cfg)
    res_alts = res_alts.clamp(-cfg.residual_bound, cfg.residual_bound)
    res_flow = torch.cat([torch.zeros_like(res_flow[:1]), res_alts], dim=0)

    with record_function("mfsr.robustness"):
        cert_alts = robustness_mask(
            warped[0], warped[1:], res_alts, cfg.robustness, bounded=2
        )[..., :3]
        cert = torch.cat([torch.ones_like(cert_alts[:1]), cert_alts], dim=0)

    with record_function("mfsr.kernel_params"):
        st = smoothed_structure_tensor(gray[0], cfg.st_window)
        merge_cfg = _scaled_merge_cfg(cfg)
        omega_inv = kernel_params(st, merge_cfg)

    with record_function("mfsr.merge"):
        num, den = merge_fast(
            warped, res_flow.contiguous(), cert.contiguous(), omega_inv.contiguous(),
            cfg.scale, cfg.merge.radius, cfg.residual_bound, k_max=merge_cfg.k_max,
        )
    with record_function("mfsr.finalize"):
        fallback = upsample_int(burst[0], cfg.scale, "bicubic")
        out = apply_weighting(num, den, fallback, cfg.merge.weight_threshold)
        if cfg.gamma:
            out = srgb_gamma(out)
        return out.clamp(0.0, 1.0)
