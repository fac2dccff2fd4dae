"""The two handheld entry points on their fast paths, in plain PyTorch:
a frozen copy of the program's ``models/handheld.py`` (its RGB
``_handheld_fast`` and RAW ``_handheld_raw_fast``) with every kernel
replaced by its plain version (``port_bench.reference.kernels``, and
``registration.tiles.tile_search`` for the search). Each entry runs on
the device of its input and does its own pre-alignment and alignment.

``hold``: a function applied to what each stage hands to the next (the
frames after pre-alignment, the warped frames, the residual flows, the
certainties, the kernel parameters, the merge's moments and the output).
The identity gives the reference; ``bfloat16_hold`` keeps each of them
in bfloat16, the control that a comparison has to fail.
"""

from __future__ import annotations

import dataclasses

import torch

from port_bench.reference.config import HandheldConfig, MergeConfig
from port_bench.reference.kernels import merge_fast, merge_raw, tile_warp
from port_bench.reference.models.fast_merge import (
    CERTLESS,
    grad_phases,
    green_guide_planes,
    raw_merge_form,
    raw_to_planes,
)
from port_bench.reference.models.merge import (
    apply_weighting,
    apply_weighting_order1,
    kernel_params,
    smoothed_structure_tensor,
    solve_order1,
    solve_plugin,
)
from port_bench.reference.models.robustness import robustness_mask
from port_bench.reference.ops.color import rgb_to_gray, srgb_gamma
from port_bench.reference.ops.geometry import downsample2_planes
from port_bench.reference.ops.restore import restore_gain, restore_phases, temporal_noise_stat
from port_bench.reference.ops.warp_fast import (
    _repeat_tiles,
    interleave_phases_planes,
    tile_shift_decompose,
    upsample_int,
    upsample_int_phases_planes,
)
from port_bench.reference.registration.align import align_burst, align_burst_consistent, flow_from_tile_shifts
from port_bench.reference.registration.lucas_kanade import lk_refine
from port_bench.reference.registration.prealign import prealign_burst, prealign_planes


def identity_hold(x: torch.Tensor) -> torch.Tensor:
    return x


def bfloat16_hold(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back (floating tensors only)."""
    return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x


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


def _align(gray: torch.Tensor, cfg: HandheldConfig) -> torch.Tensor:
    """Per-tile shifts (F, nty, ntx, 2) of a grayscale burst against frame
    0: directly, or through the shift-consistency solve."""
    if cfg.use_consistency:
        return align_burst_consistent(gray, cfg.align)
    return align_burst(gray, cfg.align)


def _gated_restore(out, cfg: HandheldConfig, stat, restore_fn):
    """The restoration FIR scaled by the noise-adaptive gain when
    cfg.restore_noise_gate, else at full strength."""
    if not cfg.restore_noise_gate:
        return restore_fn(out)
    g = restore_gain(stat, cfg.restore_gate_lo, cfg.restore_gate_hi)
    return restore_fn(out, gain=g)


def _moment_slots(cfg: HandheldConfig) -> int:
    """The fast merges' order-1 moment slots: 4 for the plugin solve, 9
    for the exact one."""
    return 4 if cfg.merge.solver == "plugin" else 9


def _o1_solve(moments, cfg: HandheldConfig, grad_fn, precomputed_centroid: bool):
    """MergeConfig.solver's order-1 solve: the plugin solver on 4 moment
    slots, or the exact 3x3 solve on 9."""
    if cfg.merge.solver == "plugin":
        return solve_plugin(moments, grad_fn, cfg.merge.plugin_iters, precomputed_centroid=precomputed_centroid)
    return solve_order1(moments, cfg.merge.ridge)


def handheld_superres(burst: torch.Tensor, cfg: HandheldConfig, hold=identity_hold) -> torch.Tensor:
    """RGB burst (F, H, W, 3) float32, frame 0 the reference -> merged
    (scale*H, scale*W, 3) in [0, 1], on the burst's device."""
    burst = hold(burst.contiguous())
    f, h, w = burst.shape[:3]
    t = cfg.align.tile_size
    gray = rgb_to_gray(burst)
    prevalid = None
    if cfg.prealign:
        burst, prevalid = prealign_burst(burst, gray, cfg.prealign_cfg)
        burst = hold(burst)
        gray = rgb_to_gray(burst)
    half = cfg.half_align and h % 2 == 0 and w % 2 == 0
    if half:
        gray_est = downsample2_planes(gray)
        warp_t = 2 * t
    else:
        gray_est = gray
        warp_t = t
    tile_shifts = _align(gray_est, cfg)
    if half:
        tile_shifts = tile_shifts * 2.0
    int_shifts, res_tiles = tile_shift_decompose(tile_shifts)

    planes = burst[1:].permute(0, 3, 1, 2)
    if prevalid is not None:
        planes = torch.cat([planes, prevalid[1:, None]], dim=1)
    warped_planes = tile_warp(planes.contiguous(), int_shifts[1:], warp_t, onehot=not cfg.warp_matmul)
    valid_w = None if prevalid is None else warped_planes[:, 3]
    warped_alts = warped_planes[:, :3].permute(0, 2, 3, 1)
    warped = hold(torch.cat([burst[:1], warped_alts], dim=0).contiguous())

    def lift(res):
        return _repeat_tiles(res, warp_t, h, w)

    if cfg.smooth_residual:
        smooth_flow = flow_from_tile_shifts(tile_shifts, warp_t, h, w)
        res_flow = smooth_flow - lift(int_shifts.float())
    else:
        res_flow = lift(res_tiles)

    half_stats = cfg.rgb_half_stats and h % 2 == 0 and w % 2 == 0
    if half_stats:
        warped_h = downsample2_planes(warped, channel_last=True)
    res_alts = res_flow[1:]
    if cfg.use_lk:
        lk_cfg = dataclasses.replace(cfg.lk, bounded_warp=max(int(cfg.residual_bound) + 1, 2))
        if half_stats:
            gray_wh = rgb_to_gray(warped_h)
            res_h = lk_refine(gray_wh[0], gray_wh[1:], downsample2_planes(res_alts, channel_last=True) * 0.5, lk_cfg)
            res_alts = (upsample_int(res_h, 2, "bilinear") * 2.0)[:, :h, :w]
        else:
            gray_w = rgb_to_gray(warped)
            res_alts = lk_refine(gray_w[0], gray_w[1:], res_alts, lk_cfg)
    res_alts = hold(res_alts.clamp(-cfg.residual_bound, cfg.residual_bound))
    res_flow = torch.cat([torch.zeros_like(res_flow[:1]), res_alts], dim=0)

    if half_stats:
        cert_h = robustness_mask(
            warped_h[0], warped_h[1:], downsample2_planes(res_alts, channel_last=True) * 0.5,
            cfg.robustness, bounded=2,
        )[..., :3]
        cert_alts = upsample_int(cert_h, 2, "bilinear")[:, :h, :w]
    else:
        cert_alts = robustness_mask(warped[0], warped[1:], res_alts, cfg.robustness, bounded=2)[..., :3]
    if valid_w is not None:
        cert_alts = cert_alts * valid_w[..., None]
    cert = hold(torch.cat([torch.ones_like(cert_alts[:1]), cert_alts], dim=0))

    st = smoothed_structure_tensor(gray[0], cfg.st_window)
    merge_cfg = _scaled_merge_cfg(cfg)
    omega_inv = hold(kernel_params(st, merge_cfg))

    rgb_order = cfg.merge.order if cfg.merge.rgb_order is None else cfg.merge.rgb_order
    merge_args = (
        warped, res_flow.contiguous(), cert.contiguous(), omega_inv.contiguous(),
        cfg.scale, cfg.merge.radius, cfg.residual_bound,
    )
    if cfg.merge.use_pallas:
        num, den = (hold(m) for m in merge_fast(*merge_args, k_max=merge_cfg.k_max))
        fallback = upsample_int(burst[0], cfg.scale, "bicubic")
        out = apply_weighting(num, den, fallback, cfg.merge.weight_threshold)
        if cfg.gamma:
            out = srgb_gamma(out)
        return hold(out.clamp(0.0, 1.0))

    moments = tuple(hold(m) for m in merge_fast(
        *merge_args, k_max=merge_cfg.k_max, phase_output=True, order=rgb_order,
        prune_exp=cfg.merge.prune_exp, moment_slots=_moment_slots(cfg), bf16=cfg.merge.bf16,
    ))
    fallback_p = upsample_int_phases_planes(burst[0], cfg.scale, "bicubic")
    if rgb_order == 1:
        est_p, m00_p = _o1_solve(moments, cfg, grad_phases, precomputed_centroid=False)
        out_p = apply_weighting_order1(est_p, m00_p, fallback_p, cfg.merge.weight_threshold)
    else:
        out_p = apply_weighting(*moments, fallback_p, cfg.merge.weight_threshold)
    if cfg.final_restore and cfg.scale == 2:
        res_half = torch.movedim(downsample2_planes(torch.movedim(res_flow[1:], -1, 1)), 1, -1)
        stat = temporal_noise_stat(downsample2_planes(rgb_to_gray(warped)), residual=res_half * 0.5)
        out_p = _gated_restore(out_p, cfg, stat, restore_phases)
    if cfg.gamma:
        out_p = srgb_gamma(out_p)
    return hold(interleave_phases_planes(out_p).clamp(0.0, 1.0))


def _subsample_from_planes(planes: torch.Tensor, cfa) -> torch.Tensor:
    """(F, 2, 2, hh, hw) CFA planes -> half-res RGB (F, hh, hw, 3) with
    same-channel sites averaged (deBayersSubSample3 semantics)."""
    pat = [[int(c) for c in row] for row in cfa]
    out = []
    for c in range(3):
        sites = [(a, b) for a in (0, 1) for b in (0, 1) if pat[a][b] == c]
        n = max(len(sites), 1)
        acc = None
        for a, b in sites:
            p = planes[:, a, b] / n
            acc = p if acc is None else acc + p
        out.append(acc if acc is not None else torch.zeros_like(planes[:, 0, 0]))
    return torch.stack(out, dim=-1)


def handheld_superres_raw(raw_burst: torch.Tensor, cfg: HandheldConfig, hold=identity_hold) -> torch.Tensor:
    """Bayer RAW burst (F, H, W) float32 in [0, 1], frame 0 the reference,
    H and W even -> merged RGB (scale*H, scale*W, 3) in [0, 1], on the
    burst's device."""
    raw_burst = hold(raw_burst.contiguous())
    f, h, w = raw_burst.shape
    t = cfg.align.tile_size
    hh, hw = h // 2, w // 2
    cfa = cfg.cfa_pattern

    planes = raw_to_planes(raw_burst)
    half = _subsample_from_planes(planes, cfa)
    gray_half = rgb_to_gray(half)
    prevalid = None
    if cfg.prealign:
        planes, prevalid = prealign_planes(planes, gray_half, cfg.prealign_cfg)
        planes = hold(planes)
        half = _subsample_from_planes(planes, cfa)
        gray_half = rgb_to_gray(half)

    tile_shifts = _align(gray_half, cfg)
    int_half, res_tiles = tile_shift_decompose(tile_shifts)

    stack = planes[1:].reshape(f - 1, 4, hh, hw)
    if prevalid is not None:
        stack = torch.cat([stack, prevalid[1:, None]], dim=1)
    warped_stack = tile_warp(stack.contiguous(), int_half[1:], t, bound=16, onehot=not cfg.warp_matmul)
    valid_w = None if prevalid is None else warped_stack[:, 4]
    warped_alts = warped_stack[:, :4].reshape(f - 1, 2, 2, hh, hw)
    warped = hold(torch.cat([planes[:1], warped_alts], dim=0))

    if cfg.smooth_residual:
        smooth_half = flow_from_tile_shifts(tile_shifts[1:], t, hh, hw)
        res_alts = smooth_half - _repeat_tiles(int_half[1:].float(), t, hh, hw)
    else:
        res_alts = _repeat_tiles(res_tiles[1:], t, hh, hw)
    warped_half = _subsample_from_planes(warped, cfa)
    gray_wh = rgb_to_gray(warped_half)
    if cfg.use_lk:
        lk_cfg = dataclasses.replace(cfg.lk, bounded_warp=2)
        res_alts = lk_refine(gray_wh[0], gray_wh[1:], res_alts, lk_cfg)
    res_alts = hold(res_alts.clamp(-0.5 * cfg.residual_bound, 0.5 * cfg.residual_bound))
    res_half = torch.cat([torch.zeros_like(res_alts[:1]), res_alts], dim=0)

    cert_alts = robustness_mask(warped_half[0], warped_half[1:], res_alts, cfg.robustness, bounded=2)[..., :3]
    if valid_w is not None:
        cert_alts = cert_alts * valid_w[..., None]
    cert_half = hold(torch.cat([torch.ones_like(cert_alts[:1]), cert_alts], dim=0))

    st = smoothed_structure_tensor(gray_half[0], cfg.st_window)
    mc = _scaled_merge_cfg(cfg)
    omega_half = hold(kernel_params(st, mc))
    mc_rb = dataclasses.replace(mc, k_min=max(mc.k_min, mc.k_min_rb))
    omega_half_rb = hold(kernel_params(st, mc_rb))

    order = cfg.merge.order
    slots = _moment_slots(cfg)
    m = cfg.merge
    guide = green_guide_planes(warped, cfa).contiguous() if m.guided_rb else None
    moments = tuple(hold(x) for x in merge_raw(
        warped.contiguous(), (res_half * 2.0).contiguous(), cert_half.contiguous(),
        omega_half.contiguous(), omega_half_rb.contiguous(), cfa, cfg.scale,
        m.radius, cfg.residual_bound, k_max=mc.k_max,
        prune_exp=m.prune_exp, order=order, moment_slots=slots,
        guide=guide, centroid_cert=m.centroid_cert, exact_weights=m.exact_weights,
        centroid_prune=m.centroid_prune, centroid_bf16=m.centroid_bf16,
        centroid_block=m.centroid_block, centroid_shared_res=m.centroid_shared_res, bf16=m.bf16,
    ))

    fallback_p = upsample_int_phases_planes(half[0], 2 * cfg.scale, "bilinear")
    if guide is not None:
        fb_g = fallback_p[:, :, 1]
        fallback_p = torch.stack([fallback_p[:, :, 0] - fb_g, fb_g, fallback_p[:, :, 2] - fb_g], dim=2)
    if order == 1:
        certless = raw_merge_form(order, slots, m.centroid_cert, m.exact_weights) == CERTLESS
        est_p, m00_p = _o1_solve(moments, cfg, grad_phases, precomputed_centroid=certless)
        out_p = apply_weighting_order1(est_p, m00_p, fallback_p, cfg.merge.weight_threshold)
    else:
        out_p = apply_weighting(*moments, fallback_p, cfg.merge.weight_threshold)
    if guide is not None:
        g = out_p[:, :, 1]
        out_p = torch.stack([g + out_p[:, :, 0], g, g + out_p[:, :, 2]], dim=2)

    if cfg.final_restore and cfg.scale == 2:
        stat = temporal_noise_stat(gray_wh, residual=res_half[1:])
        out_p = _gated_restore(out_p, cfg, stat, restore_phases)
    if cfg.gamma:
        out_p = srgb_gamma(out_p)
    return hold(interleave_phases_planes(out_p).clamp(0.0, 1.0))
